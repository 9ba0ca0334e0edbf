// The gates of one sampling frame that do not depend on the serial chain,
// as a library of its own: the entry point that the wrapper
// ops/flow_kernels.py::sample_gates and the probe call to run and time them
// alone (frame_rev.cu and seq_rev.cu launch the same kernel).
//
// Replaces: the products of lets_face_it_tpu/ops/pallas_flow.py::_kernel
// and ::_seq_rev_kernel that do not depend on the chain (the own-face
// projection hist @ w_p1[k], the hidden gates h @ w_hh[k] and the
// conditioning rows of the GRU input product).
//
// What bounds it on an H100: at B = 1 the bytes (24.9 MB of weights a frame
// for final_model, 7.5 us at 3.35 TB/s), from B = 64 on the operations.
// Design (sample_gates.cuh): two plans by rows. Few rows: K x column tiles
// x row tiles of blocks over the whole card, each weight element read once
// per launch and row tile, the rows' sums in registers. Many rows: the
// tensor-core tile product of gates_mma.cuh, 64-128 rows a block.

#include "sample_gates.cuh"

// fixed [K, B, COND], hist [B, P1], w_p1_t [K, P1, COND], states [K, B, H]
// -> proj [K, B, COND] (P1 > 0), gc, gh [K, B, 3H]. plan: GATES_PLAN_AUTO
// (the launcher's by rows), GATES_PLAN_VECTOR, or GATES_PLAN_TILE + a tile
// index; bt: rows per block, gr: column groups of four per block (8 or 32)
// of the vector plan, 0 for its defaults; mode: the matmul precision
// (flow_step.cuh::FlowPrecision). The launches made are added to
// launches[0], those of the tile plan to launches[2] too (launches[1]
// counts chains, as in the other launchers).
extern "C" int sample_gates_launch(
    const float* fixed, const float* hist, const float* w_p1_t,
    const float* states, const float* w_ih_t, const float* w_hh_t,
    const float* b_ih, const float* b_hh, float* proj, float* gc, float* gh,
    int B, int P1, int K, int Z1, int COND, int H, int bt, int gr, int plan,
    int mode, void* stream, int* launches) {
  if (B < 1 || K < 1 || COND % 4 != 0 || H % 4 != 0 || P1 % 4 != 0)
    return FLOW_ERR_ARGS;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  return (int)sample_gates_enqueue(fixed, hist, w_p1_t, states, w_ih_t, w_hh_t,
                                   b_ih, b_hh, proj, gc, gh, B, P1, K, Z1,
                                   COND, H, bt, gr, plan, mode, d,
                                   (cudaStream_t)stream, &launches[0],
                                   &launches[2]);
}

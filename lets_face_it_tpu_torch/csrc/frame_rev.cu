// Per-frame reverse flow for Hopper (sm_90a): the streaming step.
//
// Replaces: lets_face_it_tpu/ops/pallas_flow.py::_kernel (the pallas_call in
// frame_rev_fused), the streaming step's frame inversion. One call inverts
// one frame z [B, C] through the K flow steps in reverse order and advances
// the K coupling-GRU states [K, B, H], as two launches on the caller's stream:
//   1. sample_gates.cuh: gc[k] = leaky_relu(cond_projs[k]) @ w_ih_t[k][Z1:]
//      + b_ih[k] and gh[k] = states[k] @ w_hh_t[k] + b_hh[k] for all k at
//      once: 15.7 of the frame's 17.1 MB of weights (final_model), which do
//      not depend on the chain, read by the whole card (matrix-vector
//      products at few rows, tensor-core tiles from 16 or 64 rows on);
//   2. sample_chain.cuh: the serial chain of the K steps on a thread-block
//      cluster whose shared memory holds the chain's weights (1.36 MB; where
//      they do not fit, it reads them from global memory), launched to
//      overlap the end of the gates.
//
// What bounds it on an H100: the weights are read once per frame (about
// 16.6 MB for final_model, 5 us at 3.35 TB/s); the arithmetic is about
// 8.6 MFLOP per batch row (4.4 GFLOP at B = 512, 66 us at the 67 TFLOP/s of
// float32 FMA). Small batches are bound by bytes, large ones by operations;
// the chain's K serial steps add their latency at every batch.
//
// `mode` is the matmul precision of both launches
// (flow_step.cuh::FlowPrecision). The wrapper
// (ops/flow_kernels.py::frame_rev_fused) allocates the outputs
// and the gates' scratch; this file allocates nothing. It adds the gates
// and chain launches it makes to launches[0] and launches[1], and the gates
// launches of the many-row plan to launches[2] too, which the wrapper adds
// to their counters. The chain's plan holds a bounded number of rows
// (frame_rev_max_rows); the wrapper cuts a larger batch into launches of at
// most that many, as the JAX package's frame_rev_fused_chunked cuts its
// batch into 512-row kernel calls.

#include "sample_chain.cuh"
#include "sample_gates.cuh"

extern "C" int frame_rev_launch(
    const float* z, const float* cond_projs, const float* states,
    float* x_out, float* states_out,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* chain_w, float* gc, float* gh,
    int B, int K, int C, int Z1, int COND, int H, int COUT, float scale_eps,
    int mode, void* stream, int* launches) {
  ChainArgs a{chain_w, K, C, Z1, H, COUT, scale_eps, B, 0, z, gc, gh, states,
              states_out, x_out, nullptr, nullptr, 0, 0, 0, nullptr, mode};
  if (!chain_valid(a) || COND % 4 != 0) return FLOW_ERR_ARGS;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  ChainPlan plan;
  if (!chain_plan_for(B, a, 0, 0, 0, CHAIN_WEIGHTS_AUTO, d, &plan))
    return FLOW_ERR_PLAN;
  cudaStream_t st = (cudaStream_t)stream;
  err = sample_gates_enqueue(cond_projs, nullptr, nullptr, states, w_ih_t,
                             w_hh_t, b_ih, b_hh, nullptr, gc, gh, B, 0, K, Z1,
                             COND, H, 0, 0, GATES_PLAN_AUTO, mode, d, st,
                             &launches[0], &launches[2]);
  if (err != cudaSuccess) return (int)err;
  return (int)chain_enqueue(a, plan, d, st, &launches[1], true);
}

// The most rows one frame_rev_launch plans for on the current device with
// these widths: the largest B for which the chain's plan (sample_chain.cuh::
// chain_plan) fits, found by doubling and then bisecting (the plan's shared
// memory grows with B). *rows = 0 where not even one row fits.
extern "C" int frame_rev_max_rows(int K, int C, int Z1, int H, int COUT,
                                  int* rows) {
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  const auto plans = [&](int b) {
    ChainPlan plan;
    return chain_plan(b, K, C, Z1, H, COUT, 0, 0, 0, CHAIN_WEIGHTS_AUTO, d,
                      [&](const ChainPlan& p) { return chain_resident_bt(p, d); },
                      &plan);
  };
  int lo = 0, hi = 1;
  while (hi < (1 << 24) && plans(hi)) {
    lo = hi;
    hi *= 2;
  }
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (plans(mid)) lo = mid;
    else hi = mid;
  }
  *rows = lo;
  return 0;
}

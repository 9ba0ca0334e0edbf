// Per-frame reverse flow kernel for Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_flow.py::_kernel (the pallas_call in
// frame_rev_fused), the streaming step's frame inversion. One launch inverts
// one frame z [B, C] through the K flow steps in reverse order and advances
// the K coupling-GRU states [K, B, H].
//
// What bounds it on an H100: the weights are read once per frame,
// K * ((Z1+COND)*3H + H*3H + H*COUT + C*C) * 4 B (about 16.6 MB for
// final_model) -> about 5 us at 3.35 TB/s; the arithmetic is about 8.6 MFLOP
// per batch row (4.4 GFLOP at B = 512 -> about 66 us at the 67 TFLOP/s f32
// rate without tensor cores). Small batches are bounded by bytes, large ones
// by operations.
//
// Design: one block of 1024 threads per tile of BT batch rows walks
// k = K-1 .. 0 with z, the GRU input row, the gate pre-activations and the
// tile's state for step k in shared memory. Each product is split over the
// whole block (flow_step.cuh::tile_matvec): four output columns and a slice
// of the input rows per thread, so the weight rows stream in parallel. The
// 13.4 MB GRU input stack does not fit in one SM's shared memory but does fit
// in the 50 MB L2, so it is read through L2 (coalesced, each element once per
// block and step) and not staged; every block of a launch shares those L2
// lines. With one block per row tile a small batch keeps few SMs busy: at
// B = 1 one SM does all the work, so the kernel stays far above its bound
// there (see PERF.md).
//
// The launcher picks the batch tile and the shared memory from the device's
// own SM count and per-block limit. The wrapper
// (ops/flow_kernels.py::frame_rev_fused) allocates the outputs; this file
// allocates nothing and launches on the caller's stream.

#include "flow_step.cuh"

template <int BT>
__global__ void __launch_bounds__(FLOW_THREADS)
frame_rev_kernel(FlowWeights w, int B, int partial_floats,
                 const float* __restrict__ z_in,        // [B, C]
                 const float* __restrict__ cond_projs,  // [K, B, COND]
                 const float* __restrict__ states,      // [K, B, H]
                 float* __restrict__ x_out,             // [B, C]
                 float* __restrict__ states_out) {      // [K, B, H]
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = w.C, Z1 = w.Z1, COND = w.COND, H = w.H;
  const int IN = Z1 + COND;
  const int row0 = blockIdx.x * BT;
  const int rows = min(BT, B - row0);

  float* h = smem;                                   // [BT, H]
  StepScratch s = carve_step_scratch(h + round4(BT * H), BT, w, partial_floats);

  for (int idx = tid; idx < BT * C; idx += nt) {
    const int r = idx / C;
    s.z[idx] = r < rows ? z_in[(size_t)row0 * C + idx] : 0.0f;
  }

  for (int i = 0; i < w.K; ++i) {
    const int k = w.K - 1 - i;
    for (int idx = tid; idx < BT * COND; idx += nt) {
      const int r = idx / COND, c = idx - r * COND;
      const float p = r < rows
          ? cond_projs[((size_t)k * B + row0 + r) * COND + c] : 0.0f;
      s.rnn_in[r * IN + Z1 + c] = leaky_relu_(p);
    }
    // the same thread reads h[idx] into states_out below, so no race here
    for (int idx = tid; idx < BT * H; idx += nt) {
      const int r = idx / H;
      h[idx] = r < rows ? states[((size_t)k * B + row0) * H + idx] : 0.0f;
    }
    // reverse_step synchronises before reading any of these
    reverse_step<BT>(w, k, s, h);
    for (int idx = tid; idx < rows * H; idx += nt)
      states_out[((size_t)k * B + row0) * H + idx] = h[idx];
  }

  for (int idx = tid; idx < rows * C; idx += nt)
    x_out[(size_t)row0 * C + idx] = s.z[idx];
}

extern "C" int frame_rev_launch(
    const float* z, const float* cond_projs, const float* states,
    float* x_out, float* states_out,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* out_w_t, const float* out_b,
    const float* w_inv, const float* an_bias, const float* an_neg,
    int B, int K, int C, int Z1, int COND, int H, int COUT, float scale_eps,
    void* stream) {
  FlowWeights w{w_ih_t, w_hh_t, b_ih, b_hh, out_w_t, out_b, w_inv, an_bias,
                an_neg, K, C, Z1, COND, H, COUT, scale_eps};
  if (!widths_vec4(w) || B < 1) return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  auto other_floats = [&](int bt) {
    return round4(bt * H) + step_fixed_floats(bt, w);
  };
  const int widest = widest_product(w);
  const int bt = pick_bt(B, widest, d, other_floats);
  if (bt == 0) return (int)cudaErrorInvalidValue;
  const int other = other_floats(bt);
  const int partial = partial_floats_for(bt, widest, other, d.max_smem);
  const int smem = (other + partial) * (int)sizeof(float);
  const int blocks = (B + bt - 1) / bt;
  cudaStream_t st = (cudaStream_t)stream;
  FLOW_DISPATCH_BT(bt, {
    static bool smem_allowed[FLOW_MAX_DEVICES] = {};
    err = allow_max_smem(frame_rev_kernel<BT>, d, smem_allowed);
    if (err != cudaSuccess) return (int)err;
    frame_rev_kernel<BT><<<blocks, FLOW_THREADS, smem, st>>>(
        w, B, partial, z, cond_projs, states, x_out, states_out);
  });
  return (int)cudaGetLastError();
}

// Whole-sequence reverse flow kernel for Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_flow.py::_seq_rev_kernel (the
// pallas_call in sequence_rev_fused), the offline autoregressive sampling
// loop. One launch generates N frames: for each frame t the K flow steps are
// inverted in reverse order with
//   proj_k = fixed_projs[t, k] + hist @ w_p1_t[k]
// where hist [B, P1] is the flattened own-face history (oldest frame first);
// after each frame it drops its oldest C values and appends the new frame.
// The GRU states persist across frames. P1 = 0 (no own-face conditioning)
// leaves proj_k = fixed_projs[t, k] and skips the ring buffer.
//
// What bounds it on an H100: per frame the weights of the per-frame kernel
// plus w_p1 (K * P1 * COND * 4 B, 9.2 MB for final_model) are read, and the
// non-autoregressive projections fixed_projs [N, K, B, COND] are streamed
// once; about 13 MFLOP per batch row and frame. At B = 128, N = 76 the
// 318 MB of fixed_projs dominate the bytes, and the operations the time.
//
// Design: the TPU kernel's sequential frame axis of the grid becomes a loop
// inside the block (Hopper blocks run in no order). One block of 1024 threads
// per tile of BT batch rows loops over the N frames and K steps; the tile's K
// GRU states and the ring buffer (double-buffered) stay in shared memory for
// the whole sequence. Weights are read through L2 as in frame_rev.cu, and the
// own-face projection hist @ w_p1_t[k] is done in-kernel by the same split
// tile product (flow_step.cuh::tile_matvec), fixed_projs added as it is
// written out. Frames are serial by nature, so the only parallelism across
// SMs is over row tiles: at B = 1 one SM runs the whole sequence.
//
// The launcher picks the batch tile and the shared memory from the device's
// own SM count and per-block limit. The wrapper
// (ops/flow_kernels.py::sequence_rev_fused) allocates the output; this file
// allocates nothing and launches on the caller's stream.

#include "flow_step.cuh"

template <int BT>
__global__ void __launch_bounds__(FLOW_THREADS)
seq_rev_kernel(FlowWeights w, int B, int N, int P1, int partial_floats,
               const float* __restrict__ zs,           // [N, B, C]
               const float* __restrict__ fixed_projs,  // [N, K, B, COND]
               const float* __restrict__ hist0,        // [B, P1]
               const float* __restrict__ w_p1_t,       // [K, P1, COND]
               const float* __restrict__ states0,      // [K, B, H]
               float* __restrict__ xs) {               // [N, B, C]
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = w.K, C = w.C, Z1 = w.Z1, COND = w.COND, H = w.H;
  const int IN = Z1 + COND;
  const int row0 = blockIdx.x * BT;
  const int rows = min(BT, B - row0);

  float* states = smem;                              // [K, BT, H]
  float* hist = states + round4(K * BT * H);         // [BT, P1]
  float* hist_next = hist + round4(BT * P1);         // [BT, P1]
  StepScratch s = carve_step_scratch(hist_next + round4(BT * P1), BT, w,
                                     partial_floats);

  for (int idx = tid; idx < K * BT * H; idx += nt) {
    const int k = idx / (BT * H), rem = idx - k * BT * H;
    const int r = rem / H;
    states[idx] = r < rows ? states0[((size_t)k * B + row0) * H + rem] : 0.0f;
  }
  for (int idx = tid; idx < BT * P1; idx += nt) {
    const int r = idx / P1;
    hist[idx] = r < rows ? hist0[(size_t)row0 * P1 + idx] : 0.0f;
  }

  for (int t = 0; t < N; ++t) {
    for (int idx = tid; idx < BT * C; idx += nt) {
      const int r = idx / C;
      s.z[idx] = r < rows ? zs[((size_t)t * B + row0) * C + idx] : 0.0f;
    }
    for (int i = 0; i < K; ++i) {
      const int k = K - 1 - i;
      // rnn_in[:, Z1:] = leaky_relu(fixed_projs[t, k] + hist @ w_p1_t[k]);
      // tile_matvec synchronises first, so hist and z are complete
      tile_matvec<BT>(w_p1_t + (size_t)k * P1 * COND, P1, COND, hist, P1,
                      nullptr, fixed_projs + (((size_t)t * K + k) * B + row0) * COND,
                      rows, true, s.rnn_in + Z1, IN, s);
      reverse_step<BT>(w, k, s, states + (size_t)k * BT * H);
    }

    for (int idx = tid; idx < rows * C; idx += nt)
      xs[((size_t)t * B + row0) * C + idx] = s.z[idx];

    if (P1 > 0) {
      // drop the oldest frame, append the new one
      for (int idx = tid; idx < BT * P1; idx += nt) {
        const int r = idx / P1, q = idx - r * P1;
        hist_next[idx] = q < P1 - C ? hist[idx + C] : s.z[r * C + q - (P1 - C)];
      }
      float* tmp = hist;
      hist = hist_next;
      hist_next = tmp;
    }
    __syncthreads();   // every read of this frame's z and hist is done
  }
}

extern "C" int seq_rev_launch(
    const float* zs, const float* fixed_projs, const float* hist0,
    const float* w_p1_t, const float* states0, float* xs,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* out_w_t, const float* out_b,
    const float* w_inv, const float* an_bias, const float* an_neg,
    int B, int N, int P1, int K, int C, int Z1, int COND, int H, int COUT,
    float scale_eps, void* stream) {
  FlowWeights w{w_ih_t, w_hh_t, b_ih, b_hh, out_w_t, out_b, w_inv, an_bias,
                an_neg, K, C, Z1, COND, H, COUT, scale_eps};
  if (!widths_vec4(w) || B < 1 || (P1 > 0 && P1 < C))
    return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  auto other_floats = [&](int bt) {
    return round4(K * bt * H) + 2 * round4(bt * P1) + step_fixed_floats(bt, w);
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
    err = allow_max_smem(seq_rev_kernel<BT>, d, smem_allowed);
    if (err != cudaSuccess) return (int)err;
    seq_rev_kernel<BT><<<blocks, FLOW_THREADS, smem, st>>>(
        w, B, N, P1, partial, zs, fixed_projs, hist0, w_p1_t, states0, xs);
  });
  return (int)cudaGetLastError();
}

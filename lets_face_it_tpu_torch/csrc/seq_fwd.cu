// Teacher-forced flow forward over a whole sequence, for Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_train.py::_fwd_kernel (the
// pallas_call in _seq_fwd_call), the forward half of the training kernel
// pair. One launch encodes N frames through the K flow steps; for frame t
// and step k, on BT rows held in shared memory:
//   zs_res[t, k] = z                              (residual: the step input)
//   za     = (z + an_bias[k]) * an_scale[k]       (actnorm)
//   zb     = za @ W[k]                            (1x1, W = P L U)
//   rnn_in = [zb[:, :Z1] | leaky_relu(cond[t, k])]
//   h      = GRU(rnn_in, h_k)                     (gate order r, z, n)
//   st_res[t, k] = h                              (residual: the new state)
//   hout   = h @ out_w_t[k] + out_b[k]            ([shift | scale_raw] halves)
//   scale  = max(sigmoid(scale_raw + 2), eps)     -> scales[t, k]
//   z      = [zb[:, :Z1] | (zb[:, Z1:] + shift) * scale]
// and z after the K steps is z_out[t]. The GRU state h_k of step k carries
// from frame to frame; it starts at states0.
//
// What bounds it on an H100: about 533.6 kFLOP per row and step for
// final_model (the GRU input product [540 x 384] is 78 % of it), so
// N * K * B = 229,376 row-steps at B = 256, N = 56 are 122 GFLOP, 1.83 ms
// at the 67 TFLOP/s of float32 FMA; the bytes (cond 470 MB read, 197 MB of
// outputs written) take about 0.21 ms. Bound by operations.
//
// Design: the TPU kernel's sequential frame axis of the grid becomes a loop
// inside the block (Hopper blocks run in no order), as in seq_rev.cu. One
// block of 1024 threads per tile of BT batch rows loops over the N frames and
// K steps; the tile's K GRU states stay in shared memory for the whole
// sequence. Weights are read through L2 by the split tile product of
// flow_step.cuh (tile_matvec), each weight element once per block and step.
// Row tiles are the only parallelism across SMs, so at B = 256 there are 128
// blocks of 2 rows on 132 SMs, each walking N * K = 896 serial steps.
//
// The launcher picks the batch tile and the shared memory from the device's
// own SM count and per-block limit. The wrapper
// (ops/train_kernels.py::seq_fwd) allocates the outputs; this file allocates
// nothing and launches on the caller's stream.

#include "flow_step.cuh"

template <int BT>
__global__ void __launch_bounds__(FLOW_THREADS)
seq_fwd_kernel(FlowWeights w, int B, int N, int partial_floats,
               const float* __restrict__ xs,        // [N, B, C]
               const float* __restrict__ cond,      // [N, K, B, COND]
               const float* __restrict__ states0,   // [K, B, H]
               float* __restrict__ z_out,           // [N, B, C]
               float* __restrict__ scales,          // [N, K, B, COUT / 2]
               float* __restrict__ zs_res,          // [N, K, B, C]
               float* __restrict__ st_res) {        // [N, K, B, H]
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = w.K, C = w.C, Z1 = w.Z1, COND = w.COND, H = w.H;
  const int COUT = w.COUT, half = COUT / 2;
  const int IN = Z1 + COND, G = 3 * H;
  const int row0 = blockIdx.x * BT;
  const int rows = min(BT, B - row0);

  float* states = smem;                                      // [K, BT, H]
  StepScratch s = carve_step_scratch(states + round4(K * BT * H), BT, w,
                                     partial_floats);

  for (int idx = tid; idx < K * BT * H; idx += nt) {
    const int k = idx / (BT * H), rem = idx - k * BT * H;
    states[idx] = rem / H < rows
                      ? states0[((size_t)k * B + row0) * H + rem] : 0.0f;
  }

  for (int t = 0; t < N; ++t) {
    __syncthreads();   // every read of the previous frame's z is done
    for (int idx = tid; idx < BT * C; idx += nt)
      s.z[idx] = idx / C < rows ? xs[((size_t)t * B + row0) * C + idx] : 0.0f;

    for (int k = 0; k < K; ++k) {
      const size_t tk = (size_t)t * K + k;
      float* h = states + (size_t)k * BT * H;
      __syncthreads();   // z of the previous step is complete
      for (int idx = tid; idx < BT * C; idx += nt) {
        const int c = idx % C;
        if (idx / C < rows) zs_res[(tk * B + row0) * C + idx] = s.z[idx];
        s.ztmp[idx] = (s.z[idx] + w.an_bias[k * C + c]) * w.an_mul[k * C + c];
      }
      tile_matvec<BT>(w.w_mix + (size_t)k * C * C, C, C, s.ztmp, C,
                      nullptr, nullptr, 0, false, s.z, C, s);
      for (int idx = tid; idx < BT * IN; idx += nt) {
        const int r = idx / IN, j = idx - r * IN;
        float v;
        if (j < Z1)
          v = s.z[r * C + j];
        else
          v = r < rows ? leaky_relu_(cond[(tk * B + row0 + r) * COND + j - Z1])
                       : 0.0f;
        s.rnn_in[idx] = v;
      }
      tile_matvec<BT>(w.w_ih_t + (size_t)k * IN * G, IN, G, s.rnn_in, IN,
                      w.b_ih + k * G, nullptr, 0, false, s.gi, G, s);
      tile_matvec<BT>(w.w_hh_t + (size_t)k * H * G, H, G, h, H,
                      w.b_hh + k * G, nullptr, 0, false, s.gh, G, s);
      for (int idx = tid; idx < BT * H; idx += nt) {
        const int r = idx / H, j = idx - r * H;
        const float* gi = s.gi + r * G;
        const float* gh = s.gh + r * G;
        const float rg = sigmoidf_(gi[j] + gh[j]);
        const float ug = sigmoidf_(gi[H + j] + gh[H + j]);
        const float ng = tanhf(gi[2 * H + j] + rg * gh[2 * H + j]);
        const float hn = (1.0f - ug) * ng + ug * h[idx];
        h[idx] = hn;
        if (r < rows) st_res[(tk * B + row0) * H + idx] = hn;
      }
      tile_matvec<BT>(w.out_w_t + (size_t)k * H * COUT, H, COUT, h, H,
                      w.out_b + k * COUT, nullptr, 0, false, s.hout, COUT, s);
      for (int idx = tid; idx < BT * half; idx += nt) {
        const int r = idx / half, j = idx - r * half;
        const float shift = s.hout[r * COUT + j];
        const float scale = fmaxf(sigmoidf_(s.hout[r * COUT + half + j] + 2.0f),
                                  w.scale_eps);
        float* z2 = s.z + r * C + Z1 + j;
        *z2 = (*z2 + shift) * scale;
        if (r < rows) scales[(tk * B + row0) * half + idx] = scale;
      }
    }

    __syncthreads();   // the last step's z is complete
    for (int idx = tid; idx < rows * C; idx += nt)
      z_out[((size_t)t * B + row0) * C + idx] = s.z[idx];
  }
}

extern "C" int seq_fwd_launch(
    const float* xs, const float* cond, const float* states0, float* z_out,
    float* scales, float* zs_res, float* st_res,
    const float* w_mix, const float* an_bias, const float* an_scale,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* out_w_t, const float* out_b,
    int B, int N, int K, int C, int Z1, int COND, int H, int COUT,
    float scale_eps, void* stream) {
  FlowWeights w{w_ih_t, w_hh_t, b_ih, b_hh, out_w_t, out_b, w_mix, an_bias,
                an_scale, K, C, Z1, COND, H, COUT, scale_eps};
  if (!widths_vec4(w) || B < 1 || N < 1 || COUT != 2 * (C - Z1))
    return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  auto other_floats = [&](int bt) {
    return round4(K * bt * H) + step_fixed_floats(bt, w);
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
    err = allow_max_smem(seq_fwd_kernel<BT>, d, smem_allowed);
    if (err != cudaSuccess) return (int)err;
    seq_fwd_kernel<BT><<<blocks, FLOW_THREADS, smem, st>>>(
        w, B, N, partial, xs, cond, states0, z_out, scales, zs_res, st_res);
  });
  return (int)cudaGetLastError();
}

// Backward of the teacher-forced flow sequence, for Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_train.py::_bwd_kernel (the
// pallas_call in _seq_bwd_call), the mirror half of the training kernel
// pair. One launch walks the N frames in reverse and, within each frame, the
// K steps in reverse. For frame t and step k it first recomputes the step
// from the forward's residuals (the step input zs[t, k] and the previous GRU
// state hprev[t, k]) exactly as seq_fwd.cu computes it, then takes the step
// backward:
//   d_scale = dz2 * (z2 + shift) + dscales[t, k]      (z2 before coupling)
//   dhout   = [dz2 * scale | d_scale * sig * (1 - sig) where sig > eps]
//   dh      = dhout @ out_w[k] + dstate[k]            (out_w = out_w_t^T)
//   dgi, dgh: the GRU's gate cotangents (r, z, n), dghn = dgn * r
//   dstate[k] = dh * u + dgh @ w_hh[k]                (w_hh = w_hh_t^T)
//   dzb     = [dz1 + dgi @ w_ih[k][:, :Z1] | dz2 * scale]
//   dz      = (dzb @ W[k]^T) * an_scale[k]
// It threads two serial chains: dz through the steps of a frame, and the K
// state cotangents dstate through the frames (starting from dnew_states).
// Per (frame, step) it writes the local cotangents dgi, dghn, dhout and dzb,
// from which the wrapper forms every weight gradient as one contraction over
// frames and rows; per frame it writes dx, and at the end dstates0.
//
// What bounds it on an H100: the recompute (533.6 kFLOP per row and step for
// final_model) plus the four transposed products of the backward
// (dhout @ out_w, dgh @ w_hh, dgi @ w_ih[:, :Z1], dzb @ W^T: 140.4 kFLOP),
// about 674 kFLOP per row-step, 155 GFLOP or 2.31 ms at B = 256, N = 56 at
// the 67 TFLOP/s of float32 FMA; it moves about 1.27 GB (0.38 ms). Bound by
// operations.
//
// Design: as seq_fwd.cu, one block of 1024 threads per tile of BT rows loops
// over the frames and steps; the tile's K state cotangents stay in shared
// memory across frames (the TPU kernel kept them in VMEM scratch across its
// sequential grid). The transposed weights of the backward products are
// laid out by the wrapper (ops/train_kernels.py::seq_bwd) so that every
// product is the same split tile product (flow_step.cuh::tile_matvec) with
// 16-byte weight loads. This file allocates nothing and launches on the
// caller's stream.

#include "flow_step.cuh"

struct BwdWeights {
  const float* w_t;       // [K, C, C]     W^T
  const float* w_hh;      // [K, 3H, H]    w_hh_t^T
  const float* w_ih_z1;   // [K, 3H, Z1]   w_ih_t[:, :Z1]^T
  const float* out_w;     // [K, COUT, H]  out_w_t^T
};

// Shared floats of the backward's own buffers (besides the K state
// cotangents and the step scratch).
__host__ __device__ inline int bwd_extra_floats(int bt, const FlowWeights& w) {
  return 3 * round4(bt * w.H) + 2 * round4(bt * w.C) + round4(bt * w.COUT)
         + 2 * round4(bt * 3 * w.H);
}

template <int BT>
__global__ void __launch_bounds__(FLOW_THREADS)
seq_bwd_kernel(FlowWeights w, BwdWeights wb, int B, int N, int partial_floats,
               const float* __restrict__ dz_seq,      // [N, B, C]
               const float* __restrict__ dscales,     // [N, K, B, COUT / 2]
               const float* __restrict__ zs,          // [N, K, B, C]
               const float* __restrict__ hprev_g,     // [N, K, B, H]
               const float* __restrict__ dnew_states, // [K, B, H]
               const float* __restrict__ cond,        // [N, K, B, COND]
               float* __restrict__ dx,                // [N, B, C]
               float* __restrict__ dstates0,          // [K, B, H]
               float* __restrict__ dgi_g,             // [N, K, B, 3H]
               float* __restrict__ dghn_g,            // [N, K, B, H]
               float* __restrict__ dhout_g,           // [N, K, B, COUT]
               float* __restrict__ dzb_g) {           // [N, K, B, C]
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int K = w.K, C = w.C, Z1 = w.Z1, COND = w.COND, H = w.H;
  const int COUT = w.COUT, half = COUT / 2;
  const int IN = Z1 + COND, G = 3 * H;
  const int row0 = blockIdx.x * BT;
  const int rows = min(BT, B - row0);

  float* dstates = smem;                         // [K, BT, H]
  float* hprev = dstates + round4(K * BT * H);   // [BT, H]
  float* hnew = hprev + round4(BT * H);          // [BT, H]
  float* dh = hnew + round4(BT * H);             // [BT, H]
  float* dz = dh + round4(BT * H);               // [BT, C]
  float* dzb = dz + round4(BT * C);              // [BT, C]
  float* dhout = dzb + round4(BT * C);           // [BT, COUT]
  float* dgi = dhout + round4(BT * COUT);        // [BT, 3H]
  float* dgh = dgi + round4(BT * G);             // [BT, 3H]
  StepScratch s = carve_step_scratch(dgh + round4(BT * G), BT, w,
                                     partial_floats);

  for (int idx = tid; idx < K * BT * H; idx += nt) {
    const int k = idx / (BT * H), rem = idx - k * BT * H;
    dstates[idx] = rem / H < rows
                       ? dnew_states[((size_t)k * B + row0) * H + rem] : 0.0f;
  }

  for (int t = N - 1; t >= 0; --t) {
    __syncthreads();   // every read of the previous frame's dz is done
    for (int idx = tid; idx < BT * C; idx += nt)
      dz[idx] = idx / C < rows ? dz_seq[((size_t)t * B + row0) * C + idx] : 0.0f;

    for (int k = K - 1; k >= 0; --k) {
      const size_t tk = (size_t)t * K + k;
      float* dst = dstates + (size_t)k * BT * H;
      __syncthreads();   // dz of the previous step is complete

      // ---- recompute the forward step from the residuals
      for (int idx = tid; idx < BT * C; idx += nt) {
        const int c = idx % C;
        const float zin = idx / C < rows ? zs[(tk * B + row0) * C + idx] : 0.0f;
        s.ztmp[idx] = (zin + w.an_bias[k * C + c]) * w.an_mul[k * C + c];
      }
      for (int idx = tid; idx < BT * H; idx += nt)
        hprev[idx] = idx / H < rows ? hprev_g[(tk * B + row0) * H + idx] : 0.0f;
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
      tile_matvec<BT>(w.w_hh_t + (size_t)k * H * G, H, G, hprev, H,
                      w.b_hh + k * G, nullptr, 0, false, s.gh, G, s);
      for (int idx = tid; idx < BT * H; idx += nt) {
        const int r = idx / H, j = idx - r * H;
        const float* gi = s.gi + r * G;
        const float* gh = s.gh + r * G;
        const float rg = sigmoidf_(gi[j] + gh[j]);
        const float ug = sigmoidf_(gi[H + j] + gh[H + j]);
        const float ng = tanhf(gi[2 * H + j] + rg * gh[2 * H + j]);
        hnew[idx] = (1.0f - ug) * ng + ug * hprev[idx];
      }
      tile_matvec<BT>(w.out_w_t + (size_t)k * H * COUT, H, COUT, hnew, H,
                      w.out_b + k * COUT, nullptr, 0, false, s.hout, COUT, s);

      // ---- backward through the coupling
      for (int idx = tid; idx < BT * half; idx += nt) {
        const int r = idx / half, j = idx - r * half;
        const float shift = s.hout[r * COUT + j];
        const float sig = sigmoidf_(s.hout[r * COUT + half + j] + 2.0f);
        const float scale = fmaxf(sig, w.scale_eps);
        const float z2 = s.z[r * C + Z1 + j];
        const float dz2p = dz[r * C + Z1 + j];
        const float ds = r < rows ? dscales[(tk * B + row0) * half + idx] : 0.0f;
        const float dscale = dz2p * (z2 + shift) + ds;
        const float dsraw = (sig > w.scale_eps ? dscale : 0.0f) * sig * (1.0f - sig);
        dhout[r * COUT + j] = dz2p * scale;
        dhout[r * COUT + half + j] = dsraw;
        dzb[r * C + Z1 + j] = dz2p * scale;
        if (r < rows) {
          float* out = dhout_g + (tk * B + row0 + r) * COUT;
          out[j] = dz2p * scale;
          out[half + j] = dsraw;
        }
      }
      // dh = dhout @ out_w[k] + dstate[k]
      tile_matvec<BT>(wb.out_w + (size_t)k * COUT * H, COUT, H, dhout, COUT,
                      nullptr, dst, BT, false, dh, H, s);

      // ---- backward through the GRU cell
      for (int idx = tid; idx < BT * H; idx += nt) {
        const int r = idx / H, j = idx - r * H;
        const float* gi = s.gi + r * G;
        const float* gh = s.gh + r * G;
        const float rg = sigmoidf_(gi[j] + gh[j]);
        const float ug = sigmoidf_(gi[H + j] + gh[H + j]);
        const float ng = tanhf(gi[2 * H + j] + rg * gh[2 * H + j]);
        const float dhn = dh[idx];
        const float du = dhn * (hprev[idx] - ng);
        const float dn = dhn * (1.0f - ug);
        const float dgn = dn * (1.0f - ng * ng);
        const float dr = dgn * gh[2 * H + j];
        const float dghn = dgn * rg;
        const float dgr = dr * rg * (1.0f - rg);
        const float dgu = du * ug * (1.0f - ug);
        dgi[r * G + j] = dgr;
        dgi[r * G + H + j] = dgu;
        dgi[r * G + 2 * H + j] = dgn;
        dgh[r * G + j] = dgr;
        dgh[r * G + H + j] = dgu;
        dgh[r * G + 2 * H + j] = dghn;
        dst[idx] = dhn * ug;
        if (r < rows) {
          float* out = dgi_g + (tk * B + row0 + r) * G;
          out[j] = dgr;
          out[H + j] = dgu;
          out[2 * H + j] = dgn;
          dghn_g[(tk * B + row0) * H + idx] = dghn;
        }
      }
      // dstate[k] = dh * u + dgh @ w_hh[k]   (out aliases addend elementwise)
      tile_matvec<BT>(wb.w_hh + (size_t)k * G * H, G, H, dgh, G,
                      nullptr, dst, BT, false, dst, H, s);
      // dzb[:, :Z1] = dz[:, :Z1] + dgi @ w_ih[k][:, :Z1]
      tile_matvec<BT>(wb.w_ih_z1 + (size_t)k * G * Z1, G, Z1, dgi, G,
                      nullptr, nullptr, 0, false, dzb, C, s);
      for (int idx = tid; idx < BT * C; idx += nt) {
        if (idx % C < Z1) dzb[idx] += dz[idx];
        if (idx / C < rows) dzb_g[(tk * B + row0) * C + idx] = dzb[idx];
      }
      // dz = (dzb @ W[k]^T) * an_scale[k]
      tile_matvec<BT>(wb.w_t + (size_t)k * C * C, C, C, dzb, C,
                      nullptr, nullptr, 0, false, s.ztmp, C, s);
      for (int idx = tid; idx < BT * C; idx += nt)
        dz[idx] = s.ztmp[idx] * w.an_mul[k * C + idx % C];
    }

    __syncthreads();   // dz of the frame's first step is complete
    for (int idx = tid; idx < rows * C; idx += nt)
      dx[((size_t)t * B + row0) * C + idx] = dz[idx];
  }

  __syncthreads();
  for (int idx = tid; idx < K * BT * H; idx += nt) {
    const int k = idx / (BT * H), rem = idx - k * BT * H;
    if (rem / H < rows) dstates0[((size_t)k * B + row0) * H + rem] = dstates[idx];
  }
}

extern "C" int seq_bwd_launch(
    const float* dz_seq, const float* dscales, const float* zs,
    const float* hprev, const float* dnew_states, const float* cond,
    float* dx, float* dstates0, float* dgi, float* dghn, float* dhout,
    float* dzb,
    const float* w_mix, const float* an_bias, const float* an_scale,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* out_w_t, const float* out_b,
    const float* w_t, const float* w_hh, const float* w_ih_z1,
    const float* out_w,
    int B, int N, int K, int C, int Z1, int COND, int H, int COUT,
    float scale_eps, void* stream) {
  FlowWeights w{w_ih_t, w_hh_t, b_ih, b_hh, out_w_t, out_b, w_mix, an_bias,
                an_scale, K, C, Z1, COND, H, COUT, scale_eps};
  BwdWeights wb{w_t, w_hh, w_ih_z1, out_w};
  if (!widths_vec4(w) || Z1 % 4 != 0 || H % 4 != 0 || B < 1 || N < 1
      || COUT != 2 * (C - Z1))
    return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  auto other_floats = [&](int bt) {
    return round4(K * bt * H) + bwd_extra_floats(bt, w) + step_fixed_floats(bt, w);
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
    err = allow_max_smem(seq_bwd_kernel<BT>, d, smem_allowed);
    if (err != cudaSuccess) return (int)err;
    seq_bwd_kernel<BT><<<blocks, FLOW_THREADS, smem, st>>>(
        w, wb, B, N, partial, dz_seq, dscales, zs, hprev, dnew_states, cond,
        dx, dstates0, dgi, dghn, dhout, dzb);
  });
  return (int)cudaGetLastError();
}

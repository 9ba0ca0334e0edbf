// Backward of the teacher-forced flow sequence, for Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_train.py::_bwd_kernel (the
// pallas_call in _seq_bwd_call), the mirror half of the training kernel
// pair. One launch walks the N frames in reverse and, within each frame, the
// K steps in reverse. For frame t and step k it first recomputes the step
// from the forward's residuals (the step input zs[t, k], the previous GRU
// state hprev[t, k] and the conditioning gates gc[t, k] that cond_gates.cu
// computed for the forward) as seq_fwd.cu computes it, then takes the step
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
// final_model, as the TPU kernel counts it) plus the four transposed
// products (140.4 kFLOP), about 674 kFLOP per row-step, 155 GFLOP or 2.31 ms
// at B = 256, N = 56 at the 67 TFLOP/s of float32 FMA. Reading gc in place of
// the conditioning product leaves 281 kFLOP per row and step here; the chain
// is bound by moving each step's eight weights (562 KB) into the SMs.
//
// Design: as seq_fwd.cu, one block of 13 warps per tile of BT rows loops
// over the frames and steps, the tile's K state cotangents in shared memory
// across frames; the last warp streams the eight weights of every step
// through the ring of flow_stream.cuh, shared across the cluster by
// multicast, and the other 12 warps compute, fetching each step's residuals
// one step ahead. The transposed weights are laid out by the wrapper
// (ops/train_kernels.py::seq_bwd), so that every product is the same
// streamed tile product. This file allocates nothing and launches on the
// caller's stream.
//
// From H = 256 the wrapper takes the hidden split (seq_bwd_hsplit.cu, a
// library of its own; ops/train_kernels.py::seq_bwd_plan_name chooses).

#include "flow_stream.cuh"

// Floats of one step's prefetched inputs: an_bias[k], an_scale[k], b_hh[k],
// out_b[k], and the tile's rows of gc[t, k], zs[t, k], hprev[t, k],
// dscales[t, k] and (last step of a frame, the first walked) dz_seq[t].
__host__ __device__ inline int bwd_step_floats(int bt, const FlowWeights& w) {
  return 2 * w.C + 3 * w.H + w.COUT
         + bt * (3 * w.H + w.C + w.H + w.COUT / 2 + w.C);
}

// The block's other buffers: the K state cotangents, the step's vectors and
// gates, two steps of prefetched inputs.
__host__ __device__ inline int bwd_other_floats(int bt, const FlowWeights& w) {
  const int G = 3 * w.H;
  return round4(w.K * bt * w.H) + 2 * round4(bt * w.H) + 4 * round4(bt * w.C)
         + 2 * round4(bt * w.COUT) + 4 * round4(bt * G) + 2 * bwd_step_floats(bt, w);
}

template <int BT, int MODE>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
seq_bwd_kernel(FlowWeights w, BwdWeights wb, int B, int N, int nslots,
               int slot_floats, StreamTable tab, int cs,
               const float* __restrict__ dz_seq,      // [N, B, C]
               const float* __restrict__ dscales,     // [N, K, B, COUT / 2]
               const float* __restrict__ zs,          // [N, K, B, C]
               const float* __restrict__ hprev_g,     // [N, K, B, H]
               const float* __restrict__ dnew_states, // [K, B, H]
               const float* __restrict__ gc,          // [N, K, B, 3H]
               float* __restrict__ dx,                // [N, B, C]
               float* __restrict__ dstates0,          // [K, B, H]
               float* __restrict__ dgi_g,             // [N, K, B, 3H]
               float* __restrict__ dghn_g,            // [N, K, B, H]
               float* __restrict__ dhout_g,           // [N, K, B, COUT]
               float* __restrict__ dzb_g) {           // [N, K, B, C]
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x;
  const int K = w.K, C = w.C, Z1 = w.Z1, H = w.H;
  const int COUT = w.COUT, half = COUT / 2;
  const int G = 3 * H, IN = Z1 + w.COND;
  const int row0 = blockIdx.x * BT;
  const int rows = max(0, min(BT, B - row0));   // 0 in padding blocks
  const int SF = bwd_step_floats(BT, w);
  // offsets in a step's prefetch buffer
  const int o_am = C, o_bh = 2 * C, o_ob = 2 * C + G, o_gc = o_ob + COUT,
            o_zs = o_gc + BT * G, o_hp = o_zs + BT * C, o_ds = o_hp + BT * H,
            o_dz = o_ds + BT * half;

  Ring ring;
  float* dstates = carve_ring(smem, nslots, slot_floats, &ring);   // [K, BT, H]
  float* hnew = dstates + round4(K * BT * H);              // [BT, H]
  float* dh = hnew + round4(BT * H);                       // [BT, H]
  float* z = dh + round4(BT * H);                          // [BT, C]
  float* ztmp = z + round4(BT * C);                        // [BT, C]
  float* dz = ztmp + round4(BT * C);                       // [BT, C]
  float* dzb = dz + round4(BT * C);                        // [BT, C]
  float* hout = dzb + round4(BT * C);                      // [BT, COUT]
  float* dhout = hout + round4(BT * COUT);                 // [BT, COUT]
  float* gi = dhout + round4(BT * COUT);                   // [BT, 3H]
  float* gh = gi + round4(BT * G);                         // [BT, 3H]
  float* dgi = gh + round4(BT * G);                        // [BT, 3H]
  float* dgh = dgi + round4(BT * G);                       // [BT, 3H]
  float* pre = dgh + round4(BT * G);                       // [2, SF]
  float* partial = pre + 2 * SF;

  if (tid == 0) init_ring(ring, cs);
  for (int idx = tid; idx < K * BT * H; idx += STREAM_THREADS) {
    const int k = idx / (BT * H), rem = idx - k * BT * H;
    dstates[idx] = rem / H < rows
                       ? dnew_states[((size_t)k * B + row0) * H + rem] : 0.0f;
  }
  __syncthreads();
  cluster_sync();   // every block's barriers are initialised

  if (tid >= STREAM_CONSUMERS) {
    // ---- producer: the products' weights, in the consumers' order
    if (tid == STREAM_CONSUMERS) {
      const uint32_t rank = cluster_rank();
      for (int t = N - 1; t >= 0; --t)
        for (int k = K - 1; k >= 0; --k) {
          produce(ring, w.w_hh_t + (size_t)k * H * G, H, G, tab.rpc[0], rank, cs);
          produce(ring, w.w_mix + (size_t)k * C * C, C, C, tab.rpc[1], rank, cs);
          produce(ring, w.w_ih_t + (size_t)k * IN * G, Z1, G, tab.rpc[2], rank, cs);
          produce(ring, w.out_w_t + (size_t)k * H * COUT, H, COUT, tab.rpc[3],
                  rank, cs);
          produce(ring, wb.out_w + (size_t)k * COUT * H, COUT, H, tab.rpc[4],
                  rank, cs);
          produce(ring, wb.w_hh + (size_t)k * G * H, G, H, tab.rpc[5], rank, cs);
          produce(ring, wb.w_ih_z1 + (size_t)k * G * Z1, G, Z1, tab.rpc[6], rank,
                  cs);
          produce(ring, wb.w_t + (size_t)k * C * C, C, C, tab.rpc[7], rank, cs);
        }
    }
    __syncwarp();
  } else {
    // ---- consumers
    // step (t, k)'s inputs into buf, by cp.async
    auto prefetch = [&](float* buf, int t, int k) {
      const size_t tk = (size_t)t * K + k;
      const size_t rt = tk * B + row0;
      const float* spare = w.an_bias;
      prefetch_units(buf, w.an_bias + k * C, C / 4, C / 4, spare);
      prefetch_units(buf + o_am, w.an_mul + k * C, C / 4, C / 4, spare);
      prefetch_units(buf + o_bh, w.b_hh + k * G, G / 4, G / 4, spare);
      prefetch_units(buf + o_ob, w.out_b + k * COUT, COUT / 4, COUT / 4, spare);
      prefetch_units(buf + o_gc, gc + rt * G, BT * G / 4, rows * G / 4, spare);
      prefetch_units(buf + o_zs, zs + rt * C, BT * C / 4, rows * C / 4, spare);
      prefetch_units(buf + o_hp, hprev_g + rt * H, BT * H / 4, rows * H / 4,
                     spare);
      prefetch_units(buf + o_ds, dscales + rt * half, BT * half / 4,
                     rows * half / 4, spare);
      if (k == K - 1)
        prefetch_units(buf + o_dz, dz_seq + ((size_t)t * B + row0) * C,
                       BT * C / 4, rows * C / 4, spare);
      cp_async_commit();
    };
    int cur = 0;
    prefetch(pre, N - 1, K - 1);
    for (int t = N - 1; t >= 0; --t) {
      for (int k = K - 1; k >= 0; --k) {
        const size_t tk = (size_t)t * K + k;
        float* dst = dstates + (size_t)k * BT * H;
        const float* P = pre + cur * SF;
        const float* hprev = P + o_hp;
        cp_async_wait_all();
        consumer_sync();   // this step's inputs; dz of the previous step
        if (k > 0)
          prefetch(pre + (cur ^ 1) * SF, t, k - 1);
        else if (t > 0)
          prefetch(pre + (cur ^ 1) * SF, t - 1, K - 1);

        // ---- recompute the forward step from the residuals
        for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS) {
          const int c = idx % C;
          if (k == K - 1) dz[idx] = P[o_dz + idx];
          ztmp[idx] = (P[o_zs + idx] + P[c]) * P[o_am + c];
        }
        stream_matvec<BT, MODE>(ring, H, G, tab.rpc[0], tab.slices[0],
                                tab.inv_groups[0], hprev, H,
                                P + o_bh, nullptr, 0, 0, gh, G, partial);
        stream_matvec<BT, MODE>(ring, C, C, tab.rpc[1], tab.slices[1],
                          tab.inv_groups[1], ztmp, C,
                          nullptr, nullptr, 0, 0, z, C, partial);
        stream_matvec<BT, MODE>(ring, Z1, G, tab.rpc[2], tab.slices[2],
                          tab.inv_groups[2], z, C, nullptr,
                          P + o_gc, G, BT, gi, G, partial);
        for (int idx = tid; idx < BT * H; idx += STREAM_CONSUMERS) {
          const int r = idx / H, j = idx - r * H;
          const float* gir = gi + r * G;
          const float* ghr = gh + r * G;
          const float rg = sigmoidf_(gir[j] + ghr[j]);
          const float ug = sigmoidf_(gir[H + j] + ghr[H + j]);
          const float ng = tanhf(gir[2 * H + j] + rg * ghr[2 * H + j]);
          hnew[idx] = (1.0f - ug) * ng + ug * hprev[idx];
        }
        consumer_sync();
        stream_matvec<BT, MODE>(ring, H, COUT, tab.rpc[3], tab.slices[3],
                          tab.inv_groups[3], hnew, H,
                          P + o_ob, nullptr, 0, 0, hout, COUT, partial);

        // ---- backward through the coupling
        for (int idx = tid; idx < BT * half; idx += STREAM_CONSUMERS) {
          const int r = idx / half, j = idx - r * half;
          const float shift = hout[r * COUT + j];
          const float sig = sigmoidf_(hout[r * COUT + half + j] + 2.0f);
          const float scale = fmaxf(sig, w.scale_eps);
          const float z2 = z[r * C + Z1 + j];
          const float dz2p = dz[r * C + Z1 + j];
          const float dscale = dz2p * (z2 + shift) + P[o_ds + idx];
          const float dsraw =
              (sig > w.scale_eps ? dscale : 0.0f) * sig * (1.0f - sig);
          dhout[r * COUT + j] = dz2p * scale;
          dhout[r * COUT + half + j] = dsraw;
          dzb[r * C + Z1 + j] = dz2p * scale;
          if (r < rows) {
            float* out = dhout_g + (tk * B + row0 + r) * COUT;
            out[j] = dz2p * scale;
            out[half + j] = dsraw;
          }
        }
        consumer_sync();
        // dh = dhout @ out_w[k] + dstate[k]
        stream_matvec<BT, MODE>(ring, COUT, H, tab.rpc[4], tab.slices[4],
                          tab.inv_groups[4], dhout, COUT,
                          nullptr, dst, H, BT, dh, H, partial);

        // ---- backward through the GRU cell
        for (int idx = tid; idx < BT * H; idx += STREAM_CONSUMERS) {
          const int r = idx / H, j = idx - r * H;
          const float* gir = gi + r * G;
          const float* ghr = gh + r * G;
          const float rg = sigmoidf_(gir[j] + ghr[j]);
          const float ug = sigmoidf_(gir[H + j] + ghr[H + j]);
          const float ng = tanhf(gir[2 * H + j] + rg * ghr[2 * H + j]);
          const float dhn = dh[idx];
          const float du = dhn * (hprev[idx] - ng);
          const float dn = dhn * (1.0f - ug);
          const float dgn = dn * (1.0f - ng * ng);
          const float dr = dgn * ghr[2 * H + j];
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
        consumer_sync();
        // dstate[k] = dh * u + dgh @ w_hh[k]   (out aliases addend elementwise)
        stream_matvec<BT, MODE>(ring, G, H, tab.rpc[5], tab.slices[5],
                                tab.inv_groups[5], dgh, G, nullptr,
                                dst, H, BT, dst, H, partial);
        // dzb[:, :Z1] = dz[:, :Z1] + dgi @ w_ih[k][:, :Z1]
        stream_matvec<BT, MODE>(ring, G, Z1, tab.rpc[6], tab.slices[6],
                          tab.inv_groups[6], dgi, G, nullptr,
                          dz, C, BT, dzb, C, partial);
        for (int idx = tid; idx < rows * C; idx += STREAM_CONSUMERS)
          dzb_g[(tk * B + row0) * C + idx] = dzb[idx];
        // dz = (dzb @ W[k]^T) * an_scale[k]
        stream_matvec<BT, MODE>(ring, C, C, tab.rpc[7], tab.slices[7],
                          tab.inv_groups[7], dzb, C, nullptr,
                          nullptr, 0, 0, ztmp, C, partial);
        for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS)
          dz[idx] = ztmp[idx] * P[o_am + idx % C];
        cur ^= 1;
      }

      consumer_sync();   // dz of the frame's first step is complete
      for (int idx = tid; idx < rows * C; idx += STREAM_CONSUMERS)
        dx[((size_t)t * B + row0) * C + idx] = dz[idx];
    }

    consumer_sync();
    for (int idx = tid; idx < K * BT * H; idx += STREAM_CONSUMERS) {
      const int k = idx / (BT * H), rem = idx - k * BT * H;
      if (rem / H < rows) dstates0[((size_t)k * B + row0) * H + rem] = dstates[idx];
    }
  }
  cluster_sync();   // no block leaves while a peer may still signal it
}

// The backward's products, in stream order, for plan_stream.
static int bwd_products(const FlowWeights& w, StreamProduct* p) {
  const int G = 3 * w.H;
  p[0] = {w.H, G};
  p[1] = {w.C, w.C};
  p[2] = {w.Z1, G};
  p[3] = {w.H, w.COUT};
  p[4] = {w.COUT, w.H};
  p[5] = {G, w.H};
  p[6] = {G, w.Z1};
  p[7] = {w.C, w.C};
  return 8;
}

static bool bwd_plan(const FlowWeights& w, int B, int bt, int cs, int slots,
                     const FlowDevice& d, StreamPlan* plan) {
  StreamProduct prods[8];
  const int n = bwd_products(w, prods);
  return plan_stream(B, bt, cs, slots, d, prods, n,
                     [&](int b) { return bwd_other_floats(b, w); }, plan);
}

static bool bwd_valid(const FlowWeights& w, int B, int N) {
  return widths_vec4(w) && w.Z1 % 4 == 0 && w.H % 4 == 0 && B >= 1 && N >= 1
         && w.COUT == 2 * (w.C - w.Z1) && (w.COUT / 2) % 4 == 0;
}

// bt, cs, slots: rows per block, blocks per cluster and ring slots, 0 for
// the plan's defaults (a default cluster is halved until one wave holds the
// grid).
extern "C" int seq_bwd_launch(
    const float* dz_seq, const float* dscales, const float* zs,
    const float* hprev, const float* dnew_states, const float* gc,
    float* dx, float* dstates0, float* dgi, float* dghn, float* dhout,
    float* dzb,
    const float* w_mix, const float* an_bias, const float* an_scale,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* out_w_t, const float* out_b,
    const float* w_t, const float* w_hh, const float* w_ih_z1,
    const float* out_w,
    int B, int N, int K, int C, int Z1, int COND, int H, int COUT,
    float scale_eps, int bt, int cs, int slots, int mode, void* stream) {
  FlowWeights w{w_ih_t, w_hh_t, b_ih, b_hh, out_w_t, out_b, w_mix, an_bias,
                an_scale, K, C, Z1, COND, H, COUT, scale_eps};
  BwdWeights wb{w_t, w_hh, w_ih_z1, out_w};
  if (!bwd_valid(w, B, N) || !precision_valid(mode)) return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!bwd_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto replan = [&](int c, StreamPlan* p) {
    return bwd_plan(w, B, plan.bt, c, slots, d, p);
  };
  FLOW_DISPATCH_BT(plan.bt, FLOW_DISPATCH_MODE(mode, {
    static bool allowed[FLOW_MAX_DEVICES] = {};
    const auto kernel = seq_bwd_kernel<BT, MODE>;
    if (cs == 0) {
      err = fit_one_wave(kernel, d, allowed, &plan, replan);
      if (err != cudaSuccess) return (int)err;
    }
    err = launch_stream(kernel, plan, d, allowed, st, w, wb, B, N, plan.nslots,
                        plan.slot_floats, plan.table, plan.cs, dz_seq, dscales,
                        zs, hprev, dnew_states, gc, dx, dstates0, dgi, dghn, dhout,
                        dzb);
  }));
  return (int)err;
}

// As seq_fwd_plan, for this kernel.
extern "C" int seq_bwd_plan(int B, int K, int C, int Z1, int COND, int H,
                            int COUT, int bt, int cs, int slots, int* out) {
  FlowWeights w{};
  w.K = K; w.C = C; w.Z1 = Z1; w.COND = COND; w.H = H; w.COUT = COUT;
  if (!bwd_valid(w, B, 1)) return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!bwd_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  auto replan = [&](int c, StreamPlan* p) {
    return bwd_plan(w, B, plan.bt, c, slots, d, p);
  };
  int clusters = -1;
  FLOW_DISPATCH_BT(plan.bt, {
    constexpr int MODE = FLOW_F32;   // the plan is the same at every mode
    static bool allowed[FLOW_MAX_DEVICES] = {};
    const auto kernel = seq_bwd_kernel<BT, MODE>;
    if (cs == 0) {
      err = fit_one_wave(kernel, d, allowed, &plan, replan);
      if (err != cudaSuccess) return (int)err;
    }
    clusters = stream_max_clusters(kernel, plan, d, allowed);
  });
  out[0] = plan.bt; out[1] = plan.cs; out[2] = plan.blocks;
  out[3] = plan.nslots; out[4] = plan.slot_floats * 4;
  out[5] = plan.partial_floats * 4; out[6] = plan.smem_bytes;
  out[7] = clusters;
  return 0;
}

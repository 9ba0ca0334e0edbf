// Teacher-forced flow forward over a whole sequence, for Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_train.py::_fwd_kernel (the
// pallas_call in _seq_fwd_call), the forward half of the training kernel
// pair, together with cond_gates.cu. The conditioning half of the GRU input
// product, gc[t, k] = leaky_relu(cond[t, k]) @ w_ih_t[k][Z1:] + b_ih[k], does
// not depend on the serial chain; cond_gates.cu computes it for all frames
// and steps first, and this kernel runs the chain. For frame t and step k,
// on BT rows held in shared memory:
//   zs_res[t, k] = z                              (residual: the step input)
//   za     = (z + an_bias[k]) * an_scale[k]       (actnorm)
//   gh     = h_k @ w_hh_t[k] + b_hh[k]            (independent of z)
//   zb     = za @ W[k]                            (1x1, W = P L U)
//   gi     = zb[:, :Z1] @ w_ih_t[k][:Z1] + gc[t, k]
//   h_k    = GRU(gi, gh, h_k)                     (gate order r, z, n)
//   st_res[t, k] = h_k                            (residual: the new state)
//   hout   = h_k @ out_w_t[k] + out_b[k]          ([shift | scale_raw] halves)
//   scale  = max(sigmoid(scale_raw + 2), eps)     -> scales[t, k]
//   z      = [zb[:, :Z1] | (zb[:, Z1:] + shift) * scale]
// and z after the K steps is z_out[t]. The GRU state h_k of step k carries
// from frame to frame; it starts at states0.
//
// What bounds it on an H100: the pair (this kernel and cond_gates.cu) does
// about 533.6 kFLOP per row and step for final_model, 122 GFLOP or 1.83 ms at
// B = 256, N = 56 at the 67 TFLOP/s of float32 FMA; the chain's own share is
// 140 kFLOP per row and step. The chain itself is bound by moving each
// step's weights (281 KB: w_ih_t[k][:Z1], w_hh_t[k], out_w_t[k], W[k]) into
// the SMs, 896 times.
//
// Design: the TPU kernel's sequential frame axis is a loop inside the block.
// One block of 13 warps per tile of BT batch rows loops over the N frames
// and K steps, the tile's K GRU states in shared memory throughout. The last
// warp streams every step's weights, in the order the products use them,
// through a ring of shared-memory slots (flow_stream.cuh), and the blocks of
// a cluster share each chunk by multicast, so L2 serves each weight byte
// once per cluster and step, ahead of the chain. The other 12 warps compute,
// fetching each step's small inputs (gc rows, biases) one step ahead.
//
// The launcher plans rows per block, cluster size and shared memory from the
// device's own SM count and per-block limit (flow_stream.cuh::plan_stream).
// The wrapper (ops/train_kernels.py::seq_fwd) allocates the outputs; this
// file allocates nothing and launches on the caller's stream.

#include "flow_stream.cuh"

// Floats of one step's prefetched inputs: an_bias[k], an_scale[k], b_hh[k],
// out_b[k], the tile's gc[t, k] rows and (first step of a frame) its xs[t]
// rows.
__host__ __device__ inline int fwd_step_floats(int bt, const FlowWeights& w) {
  return 2 * w.C + 3 * w.H + w.COUT + bt * 3 * w.H + bt * w.C;
}

__host__ __device__ inline int fwd_other_floats(int bt, const FlowWeights& w) {
  const int G = 3 * w.H;
  return round4(w.K * bt * w.H) + 2 * round4(bt * w.C) + 2 * round4(bt * G)
         + round4(bt * w.COUT) + 2 * fwd_step_floats(bt, w);
}

template <int BT, int MODE>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
seq_fwd_kernel(FlowWeights w, int B, int N, int nslots, int slot_floats,
               StreamTable tab, int cs,
               const float* __restrict__ xs,        // [N, B, C]
               const float* __restrict__ gc,        // [N, K, B, 3H]
               const float* __restrict__ states0,   // [K, B, H]
               float* __restrict__ z_out,           // [N, B, C]
               float* __restrict__ scales,          // [N, K, B, COUT / 2]
               float* __restrict__ zs_res,          // [N, K, B, C]
               float* __restrict__ st_res) {        // [N, K, B, H]
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x;
  const int K = w.K, C = w.C, Z1 = w.Z1, H = w.H;
  const int COUT = w.COUT, half = COUT / 2;
  const int G = 3 * H, IN = Z1 + w.COND;
  const int row0 = blockIdx.x * BT;
  const int rows = max(0, min(BT, B - row0));   // 0 in padding blocks
  const int SF = fwd_step_floats(BT, w);
  // offsets in a step's prefetch buffer
  const int o_am = C, o_bh = 2 * C, o_ob = 2 * C + G, o_gc = o_ob + COUT,
            o_x = o_gc + BT * G;

  Ring ring;
  float* states = carve_ring(smem, nslots, slot_floats, &ring);   // [K, BT, H]
  float* z = states + round4(K * BT * H);                  // [BT, C]
  float* ztmp = z + round4(BT * C);                        // [BT, C]
  float* gi = ztmp + round4(BT * C);                       // [BT, 3H]
  float* gh = gi + round4(BT * G);                         // [BT, 3H]
  float* hout = gh + round4(BT * G);                       // [BT, COUT]
  float* pre = hout + round4(BT * COUT);                   // [2, SF]
  float* partial = pre + 2 * SF;

  if (tid == 0) init_ring(ring, cs);
  for (int idx = tid; idx < K * BT * H; idx += STREAM_THREADS) {
    const int k = idx / (BT * H), rem = idx - k * BT * H;
    states[idx] = rem / H < rows
                      ? states0[((size_t)k * B + row0) * H + rem] : 0.0f;
  }
  __syncthreads();
  cluster_sync();   // every block's barriers are initialised

  if (tid >= STREAM_CONSUMERS) {
    // ---- producer: the products' weights, in the consumers' order
    if (tid == STREAM_CONSUMERS) {
      const uint32_t rank = cluster_rank();
      for (int t = 0; t < N; ++t)
        for (int k = 0; k < K; ++k) {
          produce(ring, w.w_hh_t + (size_t)k * H * G, H, G, tab.rpc[0], rank, cs);
          produce(ring, w.w_mix + (size_t)k * C * C, C, C, tab.rpc[1], rank, cs);
          produce(ring, w.w_ih_t + (size_t)k * IN * G, Z1, G, tab.rpc[2], rank, cs);
          produce(ring, w.out_w_t + (size_t)k * H * COUT, H, COUT, tab.rpc[3],
                  rank, cs);
        }
    }
    __syncwarp();
  } else {
    // ---- consumers
    // step (t, k)'s inputs into buf, by cp.async
    auto prefetch = [&](float* buf, int t, int k) {
      const size_t tk = (size_t)t * K + k;
      const float* spare = w.an_bias;
      prefetch_units(buf, w.an_bias + k * C, C / 4, C / 4, spare);
      prefetch_units(buf + o_am, w.an_mul + k * C, C / 4, C / 4, spare);
      prefetch_units(buf + o_bh, w.b_hh + k * G, G / 4, G / 4, spare);
      prefetch_units(buf + o_ob, w.out_b + k * COUT, COUT / 4, COUT / 4, spare);
      prefetch_units(buf + o_gc, gc + (tk * B + row0) * G, BT * G / 4,
                     rows * G / 4, spare);
      if (k == 0)
        prefetch_units(buf + o_x, xs + ((size_t)t * B + row0) * C, BT * C / 4,
                       rows * C / 4, spare);
      cp_async_commit();
    };
    int cur = 0;
    prefetch(pre, 0, 0);
    for (int t = 0; t < N; ++t) {
      for (int k = 0; k < K; ++k) {
        const size_t tk = (size_t)t * K + k;
        float* h = states + (size_t)k * BT * H;
        const float* P = pre + cur * SF;
        cp_async_wait_all();
        consumer_sync();   // this step's inputs; z of the previous step
        if (k + 1 < K)
          prefetch(pre + (cur ^ 1) * SF, t, k + 1);
        else if (t + 1 < N)
          prefetch(pre + (cur ^ 1) * SF, t + 1, 0);
        for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS) {
          const int c = idx % C;
          const float zv = k == 0 ? P[o_x + idx] : z[idx];
          if (idx / C < rows) zs_res[(tk * B + row0) * C + idx] = zv;
          ztmp[idx] = (zv + P[c]) * P[o_am + c];
        }
        stream_matvec<BT, MODE>(ring, H, G, tab.rpc[0], tab.slices[0],
                          tab.inv_groups[0], h, H, P + o_bh,
                          nullptr, 0, 0, gh, G, partial);
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
          const float hn = (1.0f - ug) * ng + ug * h[idx];
          h[idx] = hn;
          if (r < rows) st_res[(tk * B + row0) * H + idx] = hn;
        }
        consumer_sync();   // the new state is complete
        stream_matvec<BT, MODE>(ring, H, COUT, tab.rpc[3], tab.slices[3],
                          tab.inv_groups[3], h, H,
                          P + o_ob, nullptr, 0, 0, hout, COUT, partial);
        for (int idx = tid; idx < BT * half; idx += STREAM_CONSUMERS) {
          const int r = idx / half, j = idx - r * half;
          const float shift = hout[r * COUT + j];
          const float scale = fmaxf(sigmoidf_(hout[r * COUT + half + j] + 2.0f),
                                    w.scale_eps);
          float* z2 = z + r * C + Z1 + j;
          *z2 = (*z2 + shift) * scale;
          if (r < rows) scales[(tk * B + row0) * half + idx] = scale;
        }
        cur ^= 1;
      }

      consumer_sync();   // the last step's z is complete
      for (int idx = tid; idx < rows * C; idx += STREAM_CONSUMERS)
        z_out[((size_t)t * B + row0) * C + idx] = z[idx];
    }
  }
  cluster_sync();   // no block leaves while a peer may still signal it
}

// The forward's products, in stream order, for plan_stream.
static int fwd_products(const FlowWeights& w, StreamProduct* p) {
  const int G = 3 * w.H;
  p[0] = {w.H, G};
  p[1] = {w.C, w.C};
  p[2] = {w.Z1, G};
  p[3] = {w.H, w.COUT};
  return 4;
}

static bool fwd_plan(const FlowWeights& w, int B, int bt, int cs, int slots,
                     const FlowDevice& d, StreamPlan* plan) {
  StreamProduct prods[4];
  const int n = fwd_products(w, prods);
  return plan_stream(B, bt, cs, slots, d, prods, n,
                     [&](int b) { return fwd_other_floats(b, w); }, plan);
}

static bool fwd_valid(const FlowWeights& w, int B, int N) {
  return widths_vec4(w) && w.Z1 % 4 == 0 && w.H % 4 == 0 && B >= 1 && N >= 1
         && w.COUT == 2 * (w.C - w.Z1);
}

// bt, cs, slots: rows per block, blocks per cluster and ring slots, 0 for
// the plan's defaults (a default cluster is halved until one wave holds the
// grid).
extern "C" int seq_fwd_launch(
    const float* xs, const float* gc, const float* states0, float* z_out,
    float* scales, float* zs_res, float* st_res,
    const float* w_mix, const float* an_bias, const float* an_scale,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* out_w_t, const float* out_b,
    int B, int N, int K, int C, int Z1, int COND, int H, int COUT,
    float scale_eps, int bt, int cs, int slots, int mode, void* stream) {
  FlowWeights w{w_ih_t, w_hh_t, b_ih, b_hh, out_w_t, out_b, w_mix, an_bias,
                an_scale, K, C, Z1, COND, H, COUT, scale_eps};
  if (!fwd_valid(w, B, N) || !precision_valid(mode))
    return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!fwd_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto replan = [&](int c, StreamPlan* p) {
    return fwd_plan(w, B, plan.bt, c, slots, d, p);
  };
  FLOW_DISPATCH_BT(plan.bt, FLOW_DISPATCH_MODE(mode, {
      static bool allowed[FLOW_MAX_DEVICES] = {};
      if (cs == 0) {
        err = fit_one_wave(seq_fwd_kernel<BT, MODE>, d, allowed, &plan, replan);
        if (err != cudaSuccess) return (int)err;
      }
      err = launch_stream(seq_fwd_kernel<BT, MODE>, plan, d, allowed, st, w, B, N,
                          plan.nslots, plan.slot_floats, plan.table, plan.cs, xs,
                          gc, states0, z_out, scales, zs_res, st_res);
  }));
  return (int)err;
}

// The plan the launcher would use for B rows, as out = {bt, cs, blocks,
// slots, slot bytes, partial bytes, shared bytes, clusters the device holds
// at once}; non-zero if there is none.
extern "C" int seq_fwd_plan(int B, int K, int C, int Z1, int COND, int H,
                            int COUT, int bt, int cs, int slots, int* out) {
  FlowWeights w{};
  w.K = K; w.C = C; w.Z1 = Z1; w.COND = COND; w.H = H; w.COUT = COUT;
  if (!fwd_valid(w, B, 1)) return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!fwd_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  auto replan = [&](int c, StreamPlan* p) {
    return fwd_plan(w, B, plan.bt, c, slots, d, p);
  };
  int clusters = -1;
  FLOW_DISPATCH_BT(plan.bt, {
    constexpr int MODE = FLOW_F32;   // the plan is the same at every mode
    static bool allowed[FLOW_MAX_DEVICES] = {};
    if (cs == 0) {
      err = fit_one_wave(seq_fwd_kernel<BT, MODE>, d, allowed, &plan, replan);
      if (err != cudaSuccess) return (int)err;
    }
    clusters = stream_max_clusters(seq_fwd_kernel<BT, MODE>, plan, d, allowed);
  });
  out[0] = plan.bt; out[1] = plan.cs; out[2] = plan.blocks;
  out[3] = plan.nslots; out[4] = plan.slot_floats * 4;
  out[5] = plan.partial_floats * 4; out[6] = plan.smem_bytes;
  out[7] = clusters;
  return 0;
}

// Teacher-forced flow forward over a whole sequence, hidden-split plan, for
// Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_train.py::_fwd_kernel (the
// pallas_call in _seq_fwd_call) from H = 256 on, and wherever seq_fwd.cu's
// walk cannot hold a row (ops/train_kernels.py::seq_fwd_plan_name): the
// same function as
// seq_fwd.cu, step for step (see there), after cond_gates.cu.
//
// What bounds it on an H100: as seq_fwd.cu, the chain moves each step's
// weights into the SMs; at H = 1024 they are 12.6 MB of w_hh_t a step
// (hsplit.cuh's CS blocks each move 1/CS of them), and the pair does about
// 6.7 MFLOP per row and step.
//
// Design (hsplit.cuh): a cluster of CS blocks runs one tile of BT rows, block
// r owning the hidden units U_r and their gate columns G_r. For step (t, k):
//   * each block gathers the whole previous state h_k, BT x H, from the
//     cluster's blocks (ld.shared::cluster of their units' slices);
//   * gh[:, G_r] = h_k @ w_hh_t[k][:, G_r], gi[:, G_r] (after the 1x1, which
//     every block computes whole), and the GRU of its units;
//   * its partial hout = h_k[:, U_r] @ out_w_t[k][U_r, :] goes to every peer
//     (flow_stream.cuh::Exchange), and every block sums the CS partials in
//     rank order, then runs the coupling whole.
// So one exchange a step, of BT x COUT floats a block. A block keeps its
// units' K states in a ring of K + 1 slots: the state of global step s goes
// to slot s mod (K + 1), and step s reads the one of step s - K, slot
// (s + 1) mod (K + 1), so a block never writes a slot a peer may still be
// reading (the slot it writes at step s was read at step s - 1, and every
// peer has sent its step s - 1 partial, after that read, before this block
// gets past the exchange of step s - 1). Each block streams its own weight
// columns through its ring (flow_stream.cuh::produce_local), laid out per
// block by the wrapper (ops/train_kernels.py::hsplit_weights). Rank 0 writes
// the outputs every block holds (z, scales, the step inputs); each block
// writes its units' new states.

#include "hsplit.cuh"

namespace {

// Floats of one step's prefetched inputs: an_bias[k], an_scale[k], the
// block's b_hh[k] columns, out_b[k], its gc[t, k] columns of the tile's rows
// and (first step of a frame) the tile's xs[t] rows.
__host__ __device__ inline int fwd_hs_step_floats(int bt, const FlowWeights& w,
                                                  int hs) {
  return 2 * w.C + 3 * hs + w.COUT + bt * 3 * hs + bt * w.C;
}

__host__ __device__ inline int fwd_hs_other_floats(int bt, int cs,
                                                   const FlowWeights& w) {
  const int hs = w.H / cs, gs = 3 * hs;
  return xchg_floats(cs, bt * w.COUT) + round4((w.K + 1) * bt * hs)
         + round4(bt * w.H) + 2 * round4(bt * w.C) + 2 * round4(bt * gs)
         + round4(bt * w.COUT) + 2 * fwd_hs_step_floats(bt, w, hs);
}

template <int BT, int MODE>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
seq_fwd_hsplit_kernel(FlowWeights w, HsplitWeights hw, int B, int N, int nslots,
                      int slot_floats, StreamTable tab, int cs,
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
  const int G = 3 * H, hs = H / cs, gs = 3 * hs;
  const uint32_t rank = cluster_rank();
  const bool lead = rank == 0;
  const int u0 = (int)rank * hs;
  const int row0 = (int)(blockIdx.x / cs) * BT;
  const int rows = max(0, min(BT, B - row0));   // 0 in padding clusters
  const int SF = fwd_hs_step_floats(BT, w, hs);
  // offsets in a step's prefetch buffer
  const int o_am = C, o_bh = 2 * C, o_ob = o_bh + gs, o_gc = o_ob + COUT,
            o_x = o_gc + BT * gs;
  const int ring_k = K + 1;   // state slots

  Ring ring;
  Exchange xc;
  float* hring = carve_xchg(carve_ring(smem, nslots, slot_floats, &ring), cs,
                            BT * COUT, &xc);              // [K + 1, BT, hs]
  float* hfull = hring + round4(ring_k * BT * hs);        // [BT, H]
  float* z = hfull + round4(BT * H);                      // [BT, C]
  float* ztmp = z + round4(BT * C);                       // [BT, C]
  float* gi = ztmp + round4(BT * C);                      // [BT, 3hs]
  float* gh = gi + round4(BT * gs);                       // [BT, 3hs]
  float* hp = gh + round4(BT * gs);                       // [BT, COUT]
  float* pre = hp + round4(BT * COUT);                    // [2, SF]
  float* partial = pre + 2 * SF;

  if (tid == 0) {
    init_xchg(xc);
    init_ring(ring, 1);   // its fence covers the exchange's barriers too
  }
  for (int idx = tid; idx < K * BT * hs; idx += STREAM_THREADS) {
    const int k = idx / (BT * hs), rem = idx - k * BT * hs;
    const int r = rem / hs, j = rem - r * hs;
    hring[(size_t)((k + 1) % ring_k) * BT * hs + rem] =
        r < rows ? states0[((size_t)k * B + row0 + r) * H + u0 + j] : 0.0f;
  }
  __syncthreads();
  cluster_sync();   // every block's barriers and states are initialised

  if (tid >= STREAM_CONSUMERS) {
    // ---- producer: this block's weight columns, in the consumers' order
    if (tid == STREAM_CONSUMERS) {
      for (int t = 0; t < N; ++t)
        for (int k = 0; k < K; ++k) {
          const size_t kr = (size_t)k * cs + rank;
          produce_local(ring, hw.w_hh + kr * H * gs, H, gs, tab.rpc[0]);
          produce_local(ring, w.w_mix + (size_t)k * C * C, C, C, tab.rpc[1]);
          produce_local(ring, hw.w_ih + kr * Z1 * gs, Z1, gs, tab.rpc[2]);
          produce_local(ring, w.out_w_t + ((size_t)k * H + u0) * COUT, hs, COUT,
                        tab.rpc[3]);
        }
    }
    __syncwarp();
  } else {
    // ---- consumers
    auto prefetch = [&](float* buf, int t, int k) {
      const size_t tk = (size_t)t * K + k;
      const float* spare = w.an_bias;
      prefetch_units(buf, w.an_bias + k * C, C / 4, C / 4, spare);
      prefetch_units(buf + o_am, w.an_mul + k * C, C / 4, C / 4, spare);
      prefetch_gate_cols(buf + o_bh, w.b_hh + (size_t)k * G, 0, 1, 1, H, hs, u0, spare);
      prefetch_units(buf + o_ob, w.out_b + k * COUT, COUT / 4, COUT / 4, spare);
      prefetch_gate_cols(buf + o_gc, gc + (tk * B + row0) * G, G, BT, rows, H, hs, u0,
                         spare);
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
        const int s = t * K + k;
        const float* P = pre + cur * SF;
        const float* hprev = hring + (size_t)((s + 1) % ring_k) * BT * hs;   // [BT, hs]
        float* hnew = hring + (size_t)(s % ring_k) * BT * hs;
        cp_async_wait_all();
        consumer_sync();   // this step's inputs; z and the exchange of the last step
        if (k + 1 < K)
          prefetch(pre + (cur ^ 1) * SF, t, k + 1);
        else if (t + 1 < N)
          prefetch(pre + (cur ^ 1) * SF, t + 1, 0);
        // the whole previous state h_k from the cluster's blocks
        {
          const int q = H / 4, hq = hs / 4;
          const uint32_t src = smem_u32(hprev);
          for (int idx = tid; idx < BT * q; idx += STREAM_CONSUMERS) {
            const int r = idx / q, u = idx - r * q;
            const int p = u / hq, j = u - p * hq;
            reinterpret_cast<float4*>(hfull)[idx] =
                ld_cluster_v4(cluster_map(src + 16u * (r * hq + j), (uint32_t)p));
          }
        }
        for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS) {
          const int c = idx % C;
          const float zv = k == 0 ? P[o_x + idx] : z[idx];
          if (lead && idx / C < rows) zs_res[(tk * B + row0) * C + idx] = zv;
          ztmp[idx] = (zv + P[c]) * P[o_am + c];
        }
        consumer_sync();
        stream_matvec<BT, MODE>(ring, H, gs, tab.rpc[0], tab.slices[0],
                                tab.inv_groups[0], hfull, H, P + o_bh,
                                nullptr, 0, 0, gh, gs, partial);
        stream_matvec<BT, MODE>(ring, C, C, tab.rpc[1], tab.slices[1],
                                tab.inv_groups[1], ztmp, C,
                                nullptr, nullptr, 0, 0, z, C, partial);
        stream_matvec<BT, MODE>(ring, Z1, gs, tab.rpc[2], tab.slices[2],
                                tab.inv_groups[2], z, C, nullptr,
                                P + o_gc, gs, BT, gi, gs, partial);
        for (int idx = tid; idx < BT * hs; idx += STREAM_CONSUMERS) {
          const int r = idx / hs, j = idx - r * hs;
          const float* gir = gi + r * gs;
          const float* ghr = gh + r * gs;
          const float rg = sigmoidf_(gir[j] + ghr[j]);
          const float ug = sigmoidf_(gir[hs + j] + ghr[hs + j]);
          const float ng = tanhf(gir[2 * hs + j] + rg * ghr[2 * hs + j]);
          const float hn = (1.0f - ug) * ng + ug * hprev[idx];
          hnew[idx] = hn;
          if (r < rows) st_res[(tk * B + row0 + r) * H + u0 + j] = hn;
        }
        consumer_sync();   // the block's units of the new state are complete
        // this block's part of hout = h_k @ out_w_t[k], summed over the cluster
        stream_matvec<BT, MODE>(ring, hs, COUT, tab.rpc[3], tab.slices[3],
                                tab.inv_groups[3], hnew, hs,
                                nullptr, nullptr, 0, 0, hp, COUT, partial);
        xchg_send(xc, s, hp, rank);
        const float* got = xchg_wait(xc, s);
        for (int idx = tid; idx < BT * half; idx += STREAM_CONSUMERS) {
          const int r = idx / half, j = idx - r * half;
          float sh = 0.0f, raw = 0.0f;
          for (int p = 0; p < cs; ++p) {
            const float* part = xchg_part(xc, got, p, rank, hp) + r * COUT;
            sh += part[j];
            raw += part[half + j];
          }
          const float shift = P[o_ob + j] + sh;
          const float scale =
              fmaxf(sigmoidf_(P[o_ob + half + j] + raw + 2.0f), w.scale_eps);
          float* z2 = z + r * C + Z1 + j;
          *z2 = (*z2 + shift) * scale;
          if (lead && r < rows) scales[(tk * B + row0) * half + idx] = scale;
        }
        cur ^= 1;
      }

      consumer_sync();   // the last step's z is complete
      if (lead)
        for (int idx = tid; idx < rows * C; idx += STREAM_CONSUMERS)
          z_out[((size_t)t * B + row0) * C + idx] = z[idx];
    }
  }
  cluster_sync();   // no block leaves while a peer may still read or signal it
}

// The products of a step, in stream order, at a cluster of cs.
int fwd_hs_products(const FlowWeights& w, int cs, StreamProduct* p) {
  const int hs = w.H / cs;
  p[0] = {w.H, 3 * hs};
  p[1] = {w.C, w.C};
  p[2] = {w.Z1, 3 * hs};
  p[3] = {hs, w.COUT};
  return 4;
}

bool fwd_hs_valid(const FlowWeights& w, int B, int N) {
  return widths_vec4(w) && w.Z1 % 4 == 0 && w.H % 4 == 0 && B >= 1 && N >= 1
         && w.COUT == 2 * (w.C - w.Z1);
}

// Clusters of `plan` the device holds at once (the kernel's shape is the
// same at every mode), -1 on an error.
int fwd_hs_max_clusters(const StreamPlan& plan, const FlowDevice& d) {
  static bool allowed[4][FLOW_MAX_DEVICES] = {};
  switch (plan.bt) {
    case 1: return stream_max_clusters(seq_fwd_hsplit_kernel<1, FLOW_F32>, plan, d, allowed[0]);
    case 2: return stream_max_clusters(seq_fwd_hsplit_kernel<2, FLOW_F32>, plan, d, allowed[1]);
    case 4: return stream_max_clusters(seq_fwd_hsplit_kernel<4, FLOW_F32>, plan, d, allowed[2]);
    case 8: return stream_max_clusters(seq_fwd_hsplit_kernel<8, FLOW_F32>, plan, d, allowed[3]);
    default: return -1;
  }
}

// The plan for B rows (bt, cs, slots as the launcher takes them), kept for
// the next calls with the same arguments on the same device.
bool fwd_hs_plan(const FlowWeights& w, int B, int bt, int cs, int slots,
                 const FlowDevice& d, StreamPlan* plan) {
  static HsplitMemo memo = {};
  return plan_hsplit(
      memo, w, B, bt, cs, slots, d, HSPLIT_FWD_COST,
      [&](int c, StreamProduct* p) { return fwd_hs_products(w, c, p); },
      [&](int b, int c) { return fwd_hs_other_floats(b, c, w); },
      [&](const StreamPlan& p) { return fwd_hs_max_clusters(p, d); }, plan);
}

}  // namespace

// bt, cs, slots: rows per block, blocks per cluster and ring slots, 0 for
// the planner's (hsplit.cuh::plan_hsplit; 3 slots), as seq_fwd_hsplit_plan
// was asked them (so that both find one memo entry); cs_layout: the cluster
// the weights were laid out for, FLOW_ERR_PLAN if the plan's is another.
// The weights as HsplitWeights lays them out (w_hh_s, w_ih_s), the others
// as seq_fwd.cu takes them.
extern "C" int seq_fwd_hsplit_launch(
    const float* xs, const float* gc, const float* states0, float* z_out,
    float* scales, float* zs_res, float* st_res,
    const float* w_mix, const float* an_bias, const float* an_scale,
    const float* b_hh, const float* out_w_t, const float* out_b,
    const float* w_hh_s, const float* w_ih_s,
    int B, int N, int K, int C, int Z1, int COND, int H, int COUT,
    float scale_eps, int bt, int cs, int slots, int cs_layout, int mode,
    void* stream) {
  FlowWeights w{nullptr, nullptr, nullptr, b_hh, out_w_t, out_b, w_mix, an_bias,
                an_scale, K, C, Z1, COND, H, COUT, scale_eps};
  HsplitWeights hw{w_hh_s, w_ih_s, nullptr, nullptr, nullptr};
  if (!fwd_hs_valid(w, B, N) || !precision_valid(mode))
    return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!fwd_hs_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  if (plan.cs != cs_layout) return FLOW_ERR_PLAN;
  cudaStream_t st = (cudaStream_t)stream;
  FLOW_DISPATCH_BT(plan.bt, FLOW_DISPATCH_MODE(mode, {
    static bool allowed[FLOW_MAX_DEVICES] = {};
    err = launch_stream(seq_fwd_hsplit_kernel<BT, MODE>, plan, d, allowed, st, w, hw,
                        B, N, plan.nslots, plan.slot_floats, plan.table, plan.cs, xs,
                        gc, states0, z_out, scales, zs_res, st_res);
  }));
  return (int)err;
}

// As seq_fwd.cu's seq_fwd_plan, for this plan.
extern "C" int seq_fwd_hsplit_plan(int B, int K, int C, int Z1, int COND, int H,
                                   int COUT, int bt, int cs, int slots, int* out) {
  FlowWeights w{};
  w.K = K; w.C = C; w.Z1 = Z1; w.COND = COND; w.H = H; w.COUT = COUT;
  if (!fwd_hs_valid(w, B, 1)) return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!fwd_hs_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  out[0] = plan.bt; out[1] = plan.cs; out[2] = plan.blocks;
  out[3] = plan.nslots; out[4] = plan.slot_floats * 4;
  out[5] = plan.partial_floats * 4; out[6] = plan.smem_bytes;
  out[7] = fwd_hs_max_clusters(plan, d);
  return 0;
}

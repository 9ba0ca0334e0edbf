// Backward of the teacher-forced flow sequence, hidden-split plan, for
// Hopper (sm_90a).
//
// Replaces: lets_face_it_tpu/ops/pallas_train.py::_bwd_kernel (the
// pallas_call in _seq_bwd_call) from H = 256 on, and wherever seq_bwd.cu's
// walk cannot hold a row (ops/train_kernels.py::seq_bwd_plan_name): the
// same function as seq_bwd.cu (see there for the step). The hidden gates
// of every frame and step come first, as one tile product
// (bwd_split.cuh::bwd_gh), then for each frame in reverse a walk over its
// K steps without the two products that read w_hh, and after it the
// frame's state cotangents for the frame before, dstate[k] = dh * u +
// dgh @ w_hh[k], as one tile product (bwd_split.cuh::bwd_dstate): neither
// product is on the dz chain inside a frame. A call is 1 + 2N launches.
//
// What bounds it on an H100: at H = 1024 the walk's weights are 0.8 MB a
// step (w_ih[:, :Z1] both ways, out_w both ways, W both ways) and the two
// tile products 25 MB of w_hh a frame read by every SM; the recompute and
// the cotangents are about 13.7 MFLOP per row and step.
//
// Design of the walk (hsplit.cuh): a cluster of CS blocks runs one tile of
// BT rows, block r owning the hidden units U_r and their gate columns G_r,
// and the units' K state cotangents. For step k, in reverse:
//   * the 1x1 recomputed whole in every block, gi[:, G_r], the GRU of its
//     units (gh[t, k][:, G_r] and hprev[t, k][:, U_r] prefetched);
//   * its partial hout = h[:, U_r] @ out_w_t[k][U_r, :] to every peer, the
//     CS partials summed in rank order (exchange 1, BT x COUT floats);
//   * the coupling's backward whole; dh[:, U_r] = dhout @ out_w[k][:, U_r]
//     + dstate[k][:, U_r] and the GRU's backward of its units, dgh[:, G_r]
//     written for the frame's tile product;
//   * its partial dgi[:, G_r] @ w_ih[k][G_r, :Z1] to every peer, summed in
//     rank order into dzb[:, :Z1] (exchange 2, BT x Z1 floats);
//   * dz = (dzb @ W^T) * an_scale whole.
// Rank 0 writes the outputs every block holds (dx, dhout, dzb); each block
// writes its units' and gate columns' (dgi, dghn, dgh, dh * u).

#include "bwd_split.cuh"
#include "hsplit.cuh"

namespace {

// Floats of one step's prefetched inputs: an_bias[k], an_scale[k],
// out_b[k], and of the tile's rows the block's gc[t, k] and gh[t, k]
// columns, zs[t, k], its hprev[t, k] units, dscales[t, k] and (last step of
// the frame, the first walked) dz_seq[t].
__host__ __device__ inline int bwd_hs_step_floats(int bt, const FlowWeights& w,
                                                  int hs) {
  return 2 * w.C + w.COUT
         + bt * (6 * hs + w.C + hs + w.COUT / 2 + w.C);
}

__host__ __device__ inline int bwd_hs_other_floats(int bt, int cs,
                                                   const FlowWeights& w) {
  const int hs = w.H / cs, gs = 3 * hs;
  return xchg_floats(cs, bt * w.COUT) + xchg_floats(cs, bt * w.Z1)
         + round4(w.K * bt * hs) + 2 * round4(bt * hs) + 4 * round4(bt * w.C)
         + 2 * round4(bt * w.COUT) + 2 * round4(bt * gs) + round4(bt * w.Z1)
         + 2 * bwd_hs_step_floats(bt, w, hs);
}

// One frame's walk (the pointers at the frame).
template <int BT, int MODE>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
seq_bwd_hsplit_kernel(FlowWeights w, HsplitWeights hw, int B, int nslots,
                      int slot_floats, StreamTable tab, int cs,
                      const float* __restrict__ dz_seq,      // [B, C]
                      const float* __restrict__ dscales,     // [K, B, COUT / 2]
                      const float* __restrict__ zs,          // [K, B, C]
                      const float* __restrict__ hprev_g,     // [K, B, H]
                      const float* __restrict__ dnew_states, // [K, B, H]
                      const float* __restrict__ gc,          // [K, B, 3H]
                      const float* __restrict__ gh_g,        // [K, B, 3H]
                      float* __restrict__ dx,                // [B, C]
                      float* __restrict__ dhu,               // [K, B, H]
                      float* __restrict__ dgi_g,             // [K, B, 3H]
                      float* __restrict__ dghn_g,            // [K, B, H]
                      float* __restrict__ dhout_g,           // [K, B, COUT]
                      float* __restrict__ dzb_g,             // [K, B, C]
                      float* __restrict__ dgh_g) {           // [K, B, 3H]
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
  const int SF = bwd_hs_step_floats(BT, w, hs);
  // offsets in a step's prefetch buffer
  const int o_am = C, o_ob = 2 * C, o_gc = o_ob + COUT, o_gh = o_gc + BT * gs,
            o_zs = o_gh + BT * gs, o_hp = o_zs + BT * C, o_ds = o_hp + BT * hs,
            o_dz = o_ds + BT * half;

  Ring ring;
  Exchange x1, x2;
  float* at = carve_ring(smem, nslots, slot_floats, &ring);
  at = carve_xchg(at, cs, BT * COUT, &x1);
  float* dstates = carve_xchg(at, cs, BT * Z1, &x2);      // [K, BT, hs]
  float* hnew = dstates + round4(K * BT * hs);             // [BT, hs]
  float* dh = hnew + round4(BT * hs);                      // [BT, hs]
  float* z = dh + round4(BT * hs);                         // [BT, C]
  float* ztmp = z + round4(BT * C);                        // [BT, C]
  float* dz = ztmp + round4(BT * C);                       // [BT, C]
  float* dzb = dz + round4(BT * C);                        // [BT, C]
  float* hp = dzb + round4(BT * C);                        // [BT, COUT]
  float* dhout = hp + round4(BT * COUT);                   // [BT, COUT]
  float* gi = dhout + round4(BT * COUT);                   // [BT, 3hs]
  float* dgi = gi + round4(BT * gs);                       // [BT, 3hs]
  float* zp = dgi + round4(BT * gs);                       // [BT, Z1]
  float* pre = zp + round4(BT * Z1);                       // [2, SF]
  float* partial = pre + 2 * SF;

  if (tid == 0) {
    init_xchg(x1);
    init_xchg(x2);
    init_ring(ring, 1);   // its fence covers the exchanges' barriers too
  }
  for (int idx = tid; idx < K * BT * hs; idx += STREAM_THREADS) {
    const int k = idx / (BT * hs), rem = idx - k * BT * hs;
    const int r = rem / hs, j = rem - r * hs;
    dstates[idx] = r < rows ? dnew_states[((size_t)k * B + row0 + r) * H + u0 + j] : 0.0f;
  }
  __syncthreads();
  cluster_sync();   // every block's barriers are initialised

  if (tid >= STREAM_CONSUMERS) {
    // ---- producer: this block's weight columns, in the consumers' order
    if (tid == STREAM_CONSUMERS) {
      for (int k = K - 1; k >= 0; --k) {
        const size_t kr = (size_t)k * cs + rank;
        produce_local(ring, w.w_mix + (size_t)k * C * C, C, C, tab.rpc[0]);
        produce_local(ring, hw.w_ih + kr * Z1 * gs, Z1, gs, tab.rpc[1]);
        produce_local(ring, w.out_w_t + ((size_t)k * H + u0) * COUT, hs, COUT,
                      tab.rpc[2]);
        produce_local(ring, hw.out_w + kr * COUT * hs, COUT, hs, tab.rpc[3]);
        produce_local(ring, hw.w_ih_z1 + kr * gs * Z1, gs, Z1, tab.rpc[4]);
        produce_local(ring, hw.w_t + (size_t)k * C * C, C, C, tab.rpc[5]);
      }
    }
    __syncwarp();
  } else {
    // ---- consumers
    auto prefetch = [&](float* buf, int k) {
      const size_t rt = (size_t)k * B + row0;
      const float* spare = w.an_bias;
      prefetch_units(buf, w.an_bias + k * C, C / 4, C / 4, spare);
      prefetch_units(buf + o_am, w.an_mul + k * C, C / 4, C / 4, spare);
      prefetch_units(buf + o_ob, w.out_b + k * COUT, COUT / 4, COUT / 4, spare);
      prefetch_gate_cols(buf + o_gc, gc + rt * G, G, BT, rows, H, hs, u0, spare);
      prefetch_gate_cols(buf + o_gh, gh_g + rt * G, G, BT, rows, H, hs, u0, spare);
      prefetch_units(buf + o_zs, zs + rt * C, BT * C / 4, rows * C / 4, spare);
      prefetch_unit_cols(buf + o_hp, hprev_g + rt * H, H, BT, rows, hs, u0, spare);
      prefetch_units(buf + o_ds, dscales + rt * half, BT * half / 4, rows * half / 4,
                     spare);
      if (k == K - 1)
        prefetch_units(buf + o_dz, dz_seq + (size_t)row0 * C, BT * C / 4,
                       rows * C / 4, spare);
      cp_async_commit();
    };
    int cur = 0;
    prefetch(pre, K - 1);
    for (int k = K - 1; k >= 0; --k) {
      const int use = K - 1 - k;
      const size_t rt = (size_t)k * B + row0;
      float* dst = dstates + (size_t)k * BT * hs;
      const float* P = pre + cur * SF;
      const float* ghs = P + o_gh;      // [BT, 3hs]
      const float* hprev = P + o_hp;    // [BT, hs]
      cp_async_wait_all();
      consumer_sync();   // this step's inputs; dz of the previous step
      if (k > 0) prefetch(pre + (cur ^ 1) * SF, k - 1);

      // ---- recompute the forward step from the residuals
      for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS) {
        const int c = idx % C;
        if (k == K - 1) dz[idx] = P[o_dz + idx];
        ztmp[idx] = (P[o_zs + idx] + P[c]) * P[o_am + c];
      }
      consumer_sync();
      stream_matvec<BT, MODE>(ring, C, C, tab.rpc[0], tab.slices[0],
                              tab.inv_groups[0], ztmp, C,
                              nullptr, nullptr, 0, 0, z, C, partial);
      stream_matvec<BT, MODE>(ring, Z1, gs, tab.rpc[1], tab.slices[1],
                              tab.inv_groups[1], z, C, nullptr,
                              P + o_gc, gs, BT, gi, gs, partial);
      for (int idx = tid; idx < BT * hs; idx += STREAM_CONSUMERS) {
        const int r = idx / hs, j = idx - r * hs;
        const float* gir = gi + r * gs;
        const float* ghr = ghs + r * gs;
        const float rg = sigmoidf_(gir[j] + ghr[j]);
        const float ug = sigmoidf_(gir[hs + j] + ghr[hs + j]);
        const float ng = tanhf(gir[2 * hs + j] + rg * ghr[2 * hs + j]);
        hnew[idx] = (1.0f - ug) * ng + ug * hprev[idx];
      }
      consumer_sync();
      // this block's part of hout = h @ out_w_t[k], summed over the cluster
      stream_matvec<BT, MODE>(ring, hs, COUT, tab.rpc[2], tab.slices[2],
                              tab.inv_groups[2], hnew, hs,
                              nullptr, nullptr, 0, 0, hp, COUT, partial);
      xchg_send(x1, use, hp, rank);
      const float* got = xchg_wait(x1, use);

      // ---- backward through the coupling
      for (int idx = tid; idx < BT * half; idx += STREAM_CONSUMERS) {
        const int r = idx / half, j = idx - r * half;
        float sh = 0.0f, raw = 0.0f;
        for (int p = 0; p < cs; ++p) {
          const float* part = xchg_part(x1, got, p, rank, hp) + r * COUT;
          sh += part[j];
          raw += part[half + j];
        }
        const float shift = P[o_ob + j] + sh;
        const float sig = sigmoidf_(P[o_ob + half + j] + raw + 2.0f);
        const float scale = fmaxf(sig, w.scale_eps);
        const float z2 = z[r * C + Z1 + j];
        const float dz2p = dz[r * C + Z1 + j];
        const float dscale = dz2p * (z2 + shift) + P[o_ds + idx];
        const float dsraw = (sig > w.scale_eps ? dscale : 0.0f) * sig * (1.0f - sig);
        dhout[r * COUT + j] = dz2p * scale;
        dhout[r * COUT + half + j] = dsraw;
        dzb[r * C + Z1 + j] = dz2p * scale;
        if (lead && r < rows) {
          float* out = dhout_g + (rt + r) * COUT;
          out[j] = dz2p * scale;
          out[half + j] = dsraw;
        }
      }
      consumer_sync();
      // dh = dhout @ out_w[k][:, U_r] + dstate[k][:, U_r]
      stream_matvec<BT, MODE>(ring, COUT, hs, tab.rpc[3], tab.slices[3],
                              tab.inv_groups[3], dhout, COUT,
                              nullptr, dst, hs, BT, dh, hs, partial);

      // ---- backward through the GRU cell, the block's units
      for (int idx = tid; idx < BT * hs; idx += STREAM_CONSUMERS) {
        const int r = idx / hs, j = idx - r * hs;
        const float* gir = gi + r * gs;
        const float* ghr = ghs + r * gs;
        const float rg = sigmoidf_(gir[j] + ghr[j]);
        const float ug = sigmoidf_(gir[hs + j] + ghr[hs + j]);
        const float ng = tanhf(gir[2 * hs + j] + rg * ghr[2 * hs + j]);
        const float dhn = dh[idx];
        const float du = dhn * (hprev[idx] - ng);
        const float dn = dhn * (1.0f - ug);
        const float dgn = dn * (1.0f - ng * ng);
        const float dr = dgn * ghr[2 * hs + j];
        const float dghn = dgn * rg;
        const float dgr = dr * rg * (1.0f - rg);
        const float dgu = du * ug * (1.0f - ug);
        dgi[r * gs + j] = dgr;
        dgi[r * gs + hs + j] = dgu;
        dgi[r * gs + 2 * hs + j] = dgn;
        dst[idx] = dhn * ug;
        if (r < rows) {
          float* out = dgi_g + (rt + r) * G + u0 + j;
          out[0] = dgr;
          out[H] = dgu;
          out[2 * H] = dgn;
          float* og = dgh_g + (rt + r) * G + u0 + j;
          og[0] = dgr;
          og[H] = dgu;
          og[2 * H] = dghn;
          dghn_g[(rt + r) * H + u0 + j] = dghn;
        }
      }
      consumer_sync();
      // this block's part of dgi @ w_ih[k][:, :Z1], summed over the cluster
      stream_matvec<BT, MODE>(ring, gs, Z1, tab.rpc[4], tab.slices[4],
                              tab.inv_groups[4], dgi, gs, nullptr,
                              nullptr, 0, 0, zp, Z1, partial);
      xchg_send(x2, use, zp, rank);
      const float* got2 = xchg_wait(x2, use);
      for (int idx = tid; idx < BT * Z1; idx += STREAM_CONSUMERS) {
        const int r = idx / Z1, c = idx - r * Z1;
        float sum = 0.0f;
        for (int p = 0; p < cs; ++p) sum += xchg_part(x2, got2, p, rank, zp)[idx];
        dzb[r * C + c] = dz[r * C + c] + sum;
      }
      consumer_sync();
      if (lead)
        for (int idx = tid; idx < rows * C; idx += STREAM_CONSUMERS)
          dzb_g[rt * C + idx] = dzb[idx];
      // dz = (dzb @ W[k]^T) * an_scale[k]
      stream_matvec<BT, MODE>(ring, C, C, tab.rpc[5], tab.slices[5],
                              tab.inv_groups[5], dzb, C, nullptr,
                              nullptr, 0, 0, ztmp, C, partial);
      for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS)
        dz[idx] = ztmp[idx] * P[o_am + idx % C];
      cur ^= 1;
    }

    consumer_sync();   // dz of the frame's first step is complete
    if (lead)
      for (int idx = tid; idx < rows * C; idx += STREAM_CONSUMERS)
        dx[(size_t)row0 * C + idx] = dz[idx];
    for (int idx = tid; idx < K * BT * hs; idx += STREAM_CONSUMERS) {
      const int k = idx / (BT * hs), rem = idx - k * BT * hs;
      const int r = rem / hs, j = rem - r * hs;
      if (r < rows) dhu[((size_t)k * B + row0 + r) * H + u0 + j] = dstates[idx];
    }
  }
  cluster_sync();   // no block leaves while a peer may still signal it
}

// The walk's products of a step, in stream order, at a cluster of cs.
int bwd_hs_products(const FlowWeights& w, int cs, StreamProduct* p) {
  const int hs = w.H / cs;
  p[0] = {w.C, w.C};
  p[1] = {w.Z1, 3 * hs};
  p[2] = {hs, w.COUT};
  p[3] = {w.COUT, hs};
  p[4] = {3 * hs, w.Z1};
  p[5] = {w.C, w.C};
  return 6;
}

bool bwd_hs_valid(const FlowWeights& w, int B, int N) {
  return widths_vec4(w) && w.Z1 % 4 == 0 && w.H % 4 == 0 && B >= 1 && N >= 1
         && w.COUT == 2 * (w.C - w.Z1) && (w.COUT / 2) % 4 == 0;
}

int bwd_hs_max_clusters(const StreamPlan& plan, const FlowDevice& d) {
  static bool allowed[4][FLOW_MAX_DEVICES] = {};
  switch (plan.bt) {
    case 1: return stream_max_clusters(seq_bwd_hsplit_kernel<1, FLOW_F32>, plan, d, allowed[0]);
    case 2: return stream_max_clusters(seq_bwd_hsplit_kernel<2, FLOW_F32>, plan, d, allowed[1]);
    case 4: return stream_max_clusters(seq_bwd_hsplit_kernel<4, FLOW_F32>, plan, d, allowed[2]);
    case 8: return stream_max_clusters(seq_bwd_hsplit_kernel<8, FLOW_F32>, plan, d, allowed[3]);
    default: return -1;
  }
}

// As seq_fwd_hsplit.cu's fwd_hs_plan.
bool bwd_hs_plan(const FlowWeights& w, int B, int bt, int cs, int slots,
                 const FlowDevice& d, StreamPlan* plan) {
  static HsplitMemo memo = {};
  return plan_hsplit(
      memo, w, B, bt, cs, slots, d, HSPLIT_BWD_COST,
      [&](int c, StreamProduct* p) { return bwd_hs_products(w, c, p); },
      [&](int b, int c) { return bwd_hs_other_floats(b, c, w); },
      [&](const StreamPlan& p) { return bwd_hs_max_clusters(p, d); }, plan);
}

}  // namespace

// As seq_bwd.cu's seq_bwd_launch (the same outputs), with the scratch of
// this plan's schedule: gh_all [N, K, B, 3H], dgh [K, B, 3H], dhu and
// dstate [K, B, H]; bt, cs, slots and cs_layout as seq_fwd_hsplit_launch
// takes them; w_hh_t and b_hh for the gh product, w_hh (w_hh_t^T) for the
// state cotangents' product, the others as HsplitWeights lays them out.
extern "C" int seq_bwd_hsplit_launch(
    const float* dz_seq, const float* dscales, const float* zs,
    const float* hprev, const float* dnew_states, const float* gc,
    float* dx, float* dstates0, float* dgi, float* dghn, float* dhout,
    float* dzb,
    const float* w_mix, const float* an_bias, const float* an_scale,
    const float* w_hh_t, const float* b_hh, const float* out_w_t, const float* out_b,
    const float* w_t, const float* w_hh, const float* w_ih_s, const float* out_w_s,
    const float* w_ih_z1_s, float* gh_all, float* dgh, float* dhu, float* dstate,
    int B, int N, int K, int C, int Z1, int COND, int H, int COUT,
    float scale_eps, int bt, int cs, int slots, int cs_layout, int mode,
    void* stream) {
  FlowWeights w{nullptr, w_hh_t, nullptr, b_hh, out_w_t, out_b, w_mix, an_bias,
                an_scale, K, C, Z1, COND, H, COUT, scale_eps};
  BwdWeights wb{w_t, w_hh, nullptr, nullptr};
  HsplitWeights hw{nullptr, w_ih_s, out_w_s, w_ih_z1_s, w_t};
  if (!bwd_hs_valid(w, B, N) || !precision_valid(mode)) return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!bwd_hs_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  if (plan.cs != cs_layout) return FLOW_ERR_PLAN;
  cudaStream_t st = (cudaStream_t)stream;
  FLOW_DISPATCH_BT(plan.bt, FLOW_DISPATCH_MODE(mode, {
    static bool allowed[FLOW_MAX_DEVICES] = {};
    const auto kernel = seq_bwd_hsplit_kernel<BT, MODE>;
    err = bwd_gh(w, hprev, gh_all, B, N, mode, d, st);
    const size_t bc = (size_t)B * C, kb = (size_t)K * B;
    for (int t = N - 1; t >= 0 && err == cudaSuccess; --t) {
      err = launch_stream(kernel, plan, d, allowed, st, w, hw, B, plan.nslots,
                          plan.slot_floats, plan.table, plan.cs, dz_seq + t * bc,
                          dscales + t * kb * (COUT / 2), zs + t * kb * C,
                          hprev + t * kb * H,
                          t == N - 1 ? dnew_states : (const float*)dstate,
                          gc + t * kb * 3 * H, (const float*)gh_all + t * kb * 3 * H,
                          dx + t * bc, dhu, dgi + t * kb * 3 * H, dghn + t * kb * H,
                          dhout + t * kb * COUT, dzb + t * kb * C, dgh);
      if (err == cudaSuccess)
        err = bwd_dstate(w, wb, dgh, dhu, t == 0 ? dstates0 : dstate, B, mode, d, st);
    }
  }));
  return (int)err;
}

// As seq_bwd.cu's seq_bwd_plan, for this plan's walk.
extern "C" int seq_bwd_hsplit_plan(int B, int K, int C, int Z1, int COND, int H,
                                   int COUT, int bt, int cs, int slots, int* out) {
  FlowWeights w{};
  w.K = K; w.C = C; w.Z1 = Z1; w.COND = COND; w.H = H; w.COUT = COUT;
  if (!bwd_hs_valid(w, B, 1)) return (int)cudaErrorInvalidValue;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  StreamPlan plan;
  if (!bwd_hs_plan(w, B, bt, cs, slots, d, &plan)) return (int)cudaErrorInvalidValue;
  out[0] = plan.bt; out[1] = plan.cs; out[2] = plan.blocks;
  out[3] = plan.nslots; out[4] = plan.slot_floats * 4;
  out[5] = plan.partial_floats * 4; out[6] = plan.smem_bytes;
  out[7] = bwd_hs_max_clusters(plan, d);
  return 0;
}

// What the hidden-split plan of the two serial training kernels shares
// (seq_fwd_hsplit.cu, seq_bwd_hsplit.cu): the per-block weight layouts, the
// prefetch of a block's gate columns, and the launch plan.
//
// The plan: a cluster of CS blocks shares one tile of BT batch rows, and
// block r owns the hidden units U_r = [r * Hs, (r + 1) * Hs), Hs = H / CS,
// and their gate columns G_r = {g * H + j : g = r, z, n gates, j in U_r}
// (3 Hs of them). Each block holds only its units' share of what grows with
// H (the K states or state cotangents, the gate rows, its weight columns in
// the ring), so the block is about 1/CS of the walk's; what every block
// needs whole is C-wide (the 1x1, the actnorm, the coupling) and computed
// redundantly, the same bits in every block. The products that sum over the
// hidden units or the gate columns (h @ out_w_t, dgi @ w_ih[:, :Z1]) are
// partial in each block and summed over the cluster in rank order
// (flow_stream.cuh::Exchange), so every block gets the same sums.

#pragma once

#include "flow_stream.cuh"

// The wrapper's per-block layouts (ops/train_kernels.py::hsplit_weights),
// rank r's block contiguous:
struct HsplitWeights {
  const float* w_hh;      // [K, CS, H, 3Hs]   w_hh_t[k][:, G_r]
  const float* w_ih;      // [K, CS, Z1, 3Hs]  w_ih_t[k][:Z1, G_r]
  const float* out_w;     // [K, CS, COUT, Hs] out_w_t[k][U_r, :]^T   (backward)
  const float* w_ih_z1;   // [K, CS, 3Hs, Z1]  w_ih_t[k][:Z1, G_r]^T  (backward)
  const float* w_t;       // [K, C, C]         W^T                    (backward)
};

// The consumers copy, for each of `bt` rows (the first `valid` of them
// real, the others zeros), the block's gate columns of a [*, 3H] row
// (src + r * ld: the row's G_r, 3 ranges of hs floats at u0, H + u0,
// 2H + u0) into dst [bt, 3hs], by cp.async.
__device__ __forceinline__ void prefetch_gate_cols(float* dst, const float* src,
                                                   int ld, int bt, int valid, int H,
                                                   int hs, int u0, const float* spare) {
  const int q = hs / 4, per_row = 3 * q;
  for (int idx = threadIdx.x; idx < bt * per_row; idx += STREAM_CONSUMERS) {
    const int r = idx / per_row, rem = idx - r * per_row;
    const int g = rem / q, u = rem - g * q;
    const bool ok = r < valid;
    cp_async16(dst + 4 * idx, ok ? src + (size_t)r * ld + g * H + u0 + 4 * u : spare, ok);
  }
}

// The same for the block's units of a [*, H] row: dst [bt, hs].
__device__ __forceinline__ void prefetch_unit_cols(float* dst, const float* src,
                                                   int ld, int bt, int valid, int hs,
                                                   int u0, const float* spare) {
  const int q = hs / 4;
  for (int idx = threadIdx.x; idx < bt * q; idx += STREAM_CONSUMERS) {
    const int r = idx / q, u = idx - r * q;
    const bool ok = r < valid;
    cp_async16(dst + 4 * idx, ok ? src + (size_t)r * ld + u0 + 4 * u : spare, ok);
  }
}

// Clusters the hidden split takes: H / cs a multiple of 4 (16-byte loads of
// a block's units) and 3H / cs at most 4 * STREAM_CONSUMERS.
__host__ __device__ inline bool hsplit_cluster_ok(int H, int cs) {
  return cs >= 2 && cs <= HSPLIT_MAX_CLUSTER && H % (4 * cs) == 0
         && 3 * (H / cs) <= 4 * STREAM_CONSUMERS;
}

// The launcher's cost of a plan, to compare the plans of one launch: the
// microseconds of a step of a wave of clusters, a + b * cs + wb * (c + d *
// bt + q * bt^2) + (e + h * spill) * tiles * wb * cs, times the waves the
// grid's clusters take; wb the weight floats a block streams a step, tiles
// the clusters running at once, spill the share of a frame's K steps of
// weights that the L2 cache cannot hold (read from device memory by every
// running tile). Fitted, per kernel, to the 134 tiles that
// probe_train_kernels.py --plan hsplit timed on an H100 (80GB HBM3, 700 W;
// H = 256, 512, 1024 at K = 16, B = 64 and H = 1024 at K = 32, B = 16) and
// the forward at 8 rows and a cluster of 8 at H = 1024 (96.0 ms through
// seq_fwd, its gates included, chip_smoke step 18; PERF.md): rms error 13 % for either kernel, and at each of those
// widths it picks the tile measured fastest.
struct HsplitCost {
  double a, b, c, d, q, e, h;
};
constexpr HsplitCost HSPLIT_FWD_COST = {3.098, 0.1808, 4.113e-5, 1.56e-7, 2.639e-6,
                                        0.0, 6.051e-8};
// (no backward reading spilled L2: h is not fitted)
constexpr HsplitCost HSPLIT_BWD_COST = {3.773, 0.4543, 1.208e-4, 7.06e-5, 5.298e-6,
                                        2.28e-7, 0.0};

inline double hsplit_cost(const HsplitCost& m, int bt, int cs, int waves, int tiles,
                          double wb, int K, double l2_bytes) {
  const double frame_bytes = 4.0 * K * wb * cs;
  const double spill = frame_bytes > l2_bytes ? 1.0 - l2_bytes / frame_bytes : 0.0;
  return waves * (m.a + m.b * cs + wb * (m.c + m.d * bt + m.q * bt * bt)
                  + (m.e + m.h * spill) * tiles * wb * cs);
}

// The last few plans a launcher made, by its arguments (a launch plans
// again only for arguments it has not seen lately: the wrapper asks for the
// plan once and launches with the same request, and a CUDA graph's capture
// should query no occupancy).
struct HsplitMemo {
  static constexpr int N = 4, KEYS = 11;
  int key[N][KEYS];
  StreamPlan plan[N];
  bool valid[N];
  int next;

  bool find(const int* k, StreamPlan* out) const {
    for (int i = 0; i < N; ++i) {
      bool same = valid[i];
      for (int j = 0; j < KEYS && same; ++j) same = key[i][j] == k[j];
      if (same) {
        *out = plan[i];
        return true;
      }
    }
    return false;
  }

  void put(const int* k, const StreamPlan& p) {
    for (int j = 0; j < KEYS; ++j) key[next][j] = k[j];
    plan[next] = p;
    valid[next] = true;
    next = (next + 1) % N;
  }
};

// Plans a hidden-split launch for B rows of the flow `w`: bt rows per block
// and a cluster of cs, each 0 for the planner's choice, and ring slots
// (0: STREAM_DEFAULT_SLOTS): of every (bt, cs) whose block fits
// (plan_stream without multicast, the step's products at a cluster of cs
// from products(cs, out), the block's other floats other(bt, cs)), the
// least hsplit_cost under `model`, max_clusters(plan) giving the clusters
// the device holds at once; kept in `memo` for the next calls with the same
// arguments on the same device. Returns false if none fits. The grid is
// tiles x cs blocks, a tile's blocks one cluster.
template <typename Products, typename Other, typename MaxClusters>
inline bool plan_hsplit(HsplitMemo& memo, const FlowWeights& w, int B, int bt_req,
                        int cs_req, int slots, const FlowDevice& d,
                        const HsplitCost& model, Products products, Other other,
                        MaxClusters max_clusters, StreamPlan* plan) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const int key[HsplitMemo::KEYS] = {B, w.K, w.C, w.Z1, w.COND, w.H, w.COUT, bt_req,
                                     cs_req, slots, dev};
  if (memo.find(key, plan)) return true;
  bool found = false;
  double best = 0.0;
  for (int bt = 1; bt <= FLOW_MAX_BT; bt *= 2) {
    if (bt_req && bt != bt_req) continue;
    for (int cs = 2; cs <= HSPLIT_MAX_CLUSTER; cs *= 2) {
      if ((cs_req && cs != cs_req) || !hsplit_cluster_ok(w.H, cs)) continue;
      StreamProduct prods[STREAM_MAX_PRODUCTS];
      const int n = products(cs, prods);
      StreamPlan p;
      if (!plan_stream(B, bt, cs, slots, d, prods, n,
                       [&](int b) { return other(b, cs); }, &p, false))
        continue;
      p.blocks = (B + bt - 1) / bt * cs;
      const int held = max_clusters(p);
      if (held <= 0) continue;
      double wb = 0.0;   // the block's weight floats a step
      for (int i = 0; i < n; ++i) wb += (double)prods[i].IN * prods[i].NC;
      const int clusters = p.blocks / cs;
      const double cost = hsplit_cost(model, bt, cs, (clusters + held - 1) / held,
                                      clusters < held ? clusters : held, wb, w.K,
                                      (double)d.l2_bytes);
      if (!found || cost < best) {
        best = cost;
        *plan = p;
        found = true;
      }
    }
  }
  if (found) memo.put(key, *plan);
  return found;
}

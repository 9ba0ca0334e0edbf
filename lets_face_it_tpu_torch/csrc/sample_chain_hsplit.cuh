// The sampling chain's hidden-split plan for Hopper (sm_90a): the serial
// chain of one frame (sample_chain.cuh, same function, step for step) where
// no cluster holds the weights resident: at the final widths from H = 384
// (K = 32: 256) on, and from H = 1,152, where no block can stream a whole
// step either, the only plan (ops/flow_kernels.py::chain_placement).
//
// Replaces: the serial part of lets_face_it_tpu/ops/pallas_flow.py::_kernel
// and ::_seq_rev_kernel at those widths (the K reversed steps of a frame).
//
// What bounds it on an H100: a step's chain weights grow with H (658 KB at
// H = 1,152, 2.31 MB at H = 4,096, C = 56); streamed through one SM, as the
// streaming variant does, they cost microseconds a step (0.197 ms a frame
// of 16 steps at H = 1,024 against this plan's 0.078; PERF.md). Split over a
// cluster of CS blocks, each block moves only its share (about 72 KB a step
// at H = 2,048 in a cluster of 16), so a step is bound by its latency: three
// dependent products, the GRU and the coupling, and one exchange.
//
// Design (the training pair's hidden split, hsplit.cuh): a cluster of CS
// blocks takes a tile of BT rows through all K reversed steps of the frame;
// block r owns the hidden units U_r = [r * Hs, (r + 1) * Hs), Hs = H / CS,
// and their gate columns G_r. For chain position i, step k = K - 1 - i:
//   * gi[:, G_r] = gc[k][:, G_r] + z[:, :Z1] @ w_ih_t[k][:Z1, G_r], and the
//     GRU of its units against gh[k][:, G_r] and h_prev[k][:, U_r] (both
//     from sample_gates.cuh); it writes its units of the new state;
//   * its partial h[:, U_r] @ out_w_t[k][U_r, :] goes to every peer
//     (flow_stream.cuh::Exchange), and every block sums the CS partials in
//     rank order, so every block holds the same bits;
//   * every block runs the C-wide tail redundantly: the coupling, z @ W^-1[k]
//     and the actnorm.
// So one exchange a step, of BT x COUT floats a block. A block reads only
// its own units of the states and gates: gh is given (the chain does not
// need the whole previous state, unlike the training forward). Each block
// streams its own weights through its ring (flow_stream.cuh::produce_local),
// one contiguous slab a step and rank, laid out by the wrapper
// (ops/flow_kernels.py::chain_hsplit_weights); its gate columns and states
// are fetched a step ahead by cp.async into a double buffer. Rank 0 writes
// x and the next own-face history. 12 consumer warps and one producer warp,
// as the training kernels (STREAM_THREADS).
//
// Included by sample_chain.cuh, after ChainArgs, before its launch plan.

#pragma once

#include "hsplit.cuh"

namespace {

// Floats of one rank's weights of one step (ChainArgs::weights of this
// plan, [K, CS, chain_hs_rank_floats], rank r's slab contiguous):
//   w_ih_t[k][:Z1, G_r]   [Z1, 3Hs]
//   out_w_t[k][U_r, :]    [Hs, COUT]
//   W^-1[k]               [C, C]
//   out_b[k]              [round4(COUT)]
//   an_bias[k], exp(-logs[k])  [C] each
__host__ __device__ inline int chain_hs_rank_floats(int C, int Z1, int hs, int COUT) {
  return Z1 * 3 * hs + hs * COUT + C * C + round4(COUT) + 2 * C;
}

// Floats of one step's prefetched inputs of a BT-row tile: the block's
// gc[k] and gh[k] columns [BT, 3Hs] each, its h_prev[k] units [BT, Hs],
// out_b[k], the actnorm bias and exp(-logs).
__host__ __device__ inline int chain_hs_pre_floats(int bt, int C, int COUT, int hs) {
  return 2 * bt * 3 * hs + bt * hs + round4(COUT) + 2 * C;
}

// The block's shared floats besides the ring and the partial sums.
__host__ __device__ inline int chain_hs_other_floats(int bt, int cs, int C, int H,
                                                     int COUT) {
  const int hs = H / cs;
  return xchg_floats(cs, bt * COUT) + 2 * round4(bt * C) + round4(bt * 3 * hs)
         + round4(bt * hs) + round4(bt * COUT) + 2 * chain_hs_pre_floats(bt, C, COUT, hs);
}

template <int BT, int MODE>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
sample_chain_hsplit_kernel(ChainArgs a, StreamTable tab) {
  extern __shared__ __align__(128) float smem[];
  const int tid = threadIdx.x;
  const int K = a.K, C = a.C, Z1 = a.Z1, H = a.H, COUT = a.COUT, half = COUT / 2;
  const int G = 3 * H, cs = a.cs, hs = H / cs, gs = 3 * hs;
  const uint32_t rank = cluster_rank();
  const int u0 = (int)rank * hs;
  const int row0 = (int)(blockIdx.x / cs) * BT;
  const int rows = min(BT, a.B - row0);   // every cluster has rows
  const int RF = a.step_floats;           // a rank's floats of a step
  // offsets in a rank's slab of a step
  const int o_wo = Z1 * gs, o_wi = o_wo + hs * COUT, o_ob = o_wi + C * C;
  // offsets in a step's prefetch buffer
  const int PF = chain_hs_pre_floats(BT, C, COUT, hs);
  const int p_gh = BT * gs, p_hp = 2 * BT * gs, p_ob = p_hp + BT * hs,
            p_ab = p_ob + round4(COUT), p_am = p_ab + C;

  Ring ring;
  Exchange xc;
  float* z = carve_xchg(carve_ring(smem, a.nslots, a.slot_floats, &ring), cs,
                        BT * COUT, &xc);                  // [BT, C]
  float* ztmp = z + round4(BT * C);                       // [BT, C]
  float* gi = ztmp + round4(BT * C);                      // [BT, 3Hs]
  float* hnew = gi + round4(BT * gs);                     // [BT, Hs]
  float* hp = hnew + round4(BT * hs);                     // [BT, COUT]
  float* pre = hp + round4(BT * COUT);                    // [2, PF]
  float* partial = pre + 2 * PF;

  if (tid == 0) {
    init_xchg(xc);
    init_ring(ring, 1);   // its fence covers the exchange's barriers too
  }
  __syncthreads();
  cluster_sync();   // every block's barriers are initialised

  if (tid >= STREAM_CONSUMERS) {
    // ---- producer: this block's slab of each step, in chain order
    if (tid == STREAM_CONSUMERS) {
      for (int i = 0; i < K; ++i) {
        const float* ws = a.weights + ((size_t)(K - 1 - i) * cs + rank) * RF;
        produce_local(ring, ws, Z1, gs, tab.rpc[0]);
        produce_local(ring, ws + o_wo, hs, COUT, tab.rpc[1]);
        produce_local(ring, ws + o_wi, C, C, tab.rpc[2]);
      }
    }
    __syncwarp();
  } else {
    // ---- consumers
    // Launched as a programmatic dependent of the gates kernel, the set-up
    // above overlaps it; nothing it wrote is read before this point.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const float* spare = a.weights;
    auto prefetch = [&](float* buf, int i) {
      const int k = K - 1 - i;
      const size_t kr = (size_t)k * a.B + row0;
      prefetch_gate_cols(buf, a.gc + kr * G, G, BT, rows, H, hs, u0, spare);
      prefetch_gate_cols(buf + p_gh, a.gh + kr * G, G, BT, rows, H, hs, u0, spare);
      prefetch_unit_cols(buf + p_hp, a.states_in + kr * H, H, BT, rows, hs, u0, spare);
      const float* ws = a.weights + ((size_t)k * cs + rank) * RF + o_ob;
      prefetch_units(buf + p_ob, ws, round4(COUT) / 4 + C / 2, round4(COUT) / 4 + C / 2,
                     spare);   // out_b, an_bias, exp(-logs): contiguous
      cp_async_commit();
    };
    prefetch(pre, 0);
    for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS)
      z[idx] = idx / C < rows ? a.z_in[(size_t)row0 * C + idx] : 0.0f;
    int cur = 0;
    for (int i = 0; i < K; ++i) {
      const int k = K - 1 - i;
      const float* P = pre + cur * PF;
      cp_async_wait_all();
      consumer_sync();   // this step's inputs; z of the last step
      if (i + 1 < K) prefetch(pre + (cur ^ 1) * PF, i + 1);
      // gi = gc + z[:, :Z1] @ w_ih_t[k][:Z1, G_r]
      stream_matvec<BT, MODE>(ring, Z1, gs, tab.rpc[0], tab.slices[0],
                              tab.inv_groups[0], z, C, nullptr, P, gs, BT, gi, gs,
                              partial);
      // the GRU of the block's units
      for (int idx = tid; idx < BT * hs; idx += STREAM_CONSUMERS) {
        const int r = idx / hs, j = idx - r * hs;
        const float* gir = gi + r * gs;
        const float* ghr = P + p_gh + r * gs;
        const float rg = sigmoidf_(gir[j] + ghr[j]);
        const float ug = sigmoidf_(gir[hs + j] + ghr[hs + j]);
        const float ng = tanhf(gir[2 * hs + j] + rg * ghr[2 * hs + j]);
        const float h = (1.0f - ug) * ng + ug * P[p_hp + idx];
        hnew[idx] = h;
        if (r < rows) a.states_out[((size_t)k * a.B + row0 + r) * H + u0 + j] = h;
      }
      consumer_sync();
      // this block's part of h @ out_w_t[k], summed over the cluster
      stream_matvec<BT, MODE>(ring, hs, COUT, tab.rpc[1], tab.slices[1],
                              tab.inv_groups[1], hnew, hs, nullptr, nullptr, 0, 0,
                              hp, COUT, partial);
      xchg_send(xc, i, hp, rank);
      const float* got = xchg_wait(xc, i);
      // the coupling: z2 = z2 / scale - shift
      for (int idx = tid; idx < BT * half; idx += STREAM_CONSUMERS) {
        const int r = idx / half, j = idx - r * half;
        float sh = 0.0f, raw = 0.0f;
        for (int p = 0; p < cs; ++p) {
          const float* part = xchg_part(xc, got, p, rank, hp) + r * COUT;
          sh += part[j];
          raw += part[half + j];
        }
        const float shift = sh + P[p_ob + j];
        const float scale =
            fmaxf(sigmoidf_(raw + P[p_ob + half + j] + 2.0f), a.scale_eps);
        float* z2 = z + r * C + Z1 + j;
        *z2 = *z2 / scale - shift;
      }
      consumer_sync();
      // z = (z @ W^-1[k]) * exp(-logs[k]) - bias[k]
      stream_matvec<BT, MODE>(ring, C, C, tab.rpc[2], tab.slices[2],
                              tab.inv_groups[2], z, C, nullptr, nullptr, 0, 0, ztmp,
                              C, partial);
      for (int idx = tid; idx < BT * C; idx += STREAM_CONSUMERS) {
        const int c = idx % C;
        z[idx] = ztmp[idx] * P[p_am + c] - P[p_ab + c];
      }
      cur ^= 1;
    }
    consumer_sync();   // the last step's z is complete
    if (rank == 0) {
      for (int idx = tid; idx < rows * C; idx += STREAM_CONSUMERS)
        a.x_out[(size_t)row0 * C + idx] = z[idx];
      const int P1 = a.P1;
      for (int idx = tid; idx < rows * P1; idx += STREAM_CONSUMERS) {
        const int r = idx / P1, q1 = idx - r * P1;
        a.hist_out[(size_t)row0 * P1 + idx] =
            q1 < P1 - C ? a.hist_in[(size_t)row0 * P1 + idx + C]
                        : z[r * C + q1 - (P1 - C)];
      }
    }
  }
  cluster_sync();   // no block leaves while a peer may still signal it
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The products of a step, in stream order, at a cluster of cs.
inline int chain_hs_products(int C, int Z1, int H, int COUT, int cs,
                             StreamProduct* p) {
  const int hs = H / cs;
  p[0] = {Z1, 3 * hs};
  p[1] = {hs, COUT};
  p[2] = {C, C};
  return 3;
}

// A block of the plan for B rows at bt rows a tile in a cluster of cs, its
// ring of `slots` slots (0: STREAM_DEFAULT_SLOTS): the ring, partial sums
// and table of flow_stream.cuh::plan_stream (without multicast), the grid
// one cluster a tile. False if the cluster does not split H
// (hsplit.cuh::hsplit_cluster_ok), Z1 is not a multiple of 4 or the block
// does not fit.
inline bool chain_hs_block(int B, int C, int Z1, int H, int COUT, int bt, int cs,
                           int slots, const FlowDevice& d, StreamPlan* p) {
  if (!hsplit_cluster_ok(H, cs) || Z1 % 4 != 0) return false;
  StreamProduct prods[3];
  const int n = chain_hs_products(C, Z1, H, COUT, cs, prods);
  if (!plan_stream(B, bt, cs, slots, d, prods, n,
                   [&](int b) { return chain_hs_other_floats(b, cs, C, H, COUT); }, p,
                   false))
    return false;
  p->blocks = (B + bt - 1) / bt * cs;
  return true;
}

template <int BT, int MODE>
inline cudaError_t chain_hs_launch(const cudaLaunchConfig_t& cfg, const ChainArgs& a,
                                   const StreamTable& tab, const FlowDevice& d) {
  static bool allowed[FLOW_MAX_DEVICES] = {};
  const auto kernel = sample_chain_hsplit_kernel<BT, MODE>;
  cudaError_t err = allow_stream(kernel, d, allowed);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, a, tab);
}

}  // namespace

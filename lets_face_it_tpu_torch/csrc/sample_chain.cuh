// The serial chain of the sampling flow for Hopper (sm_90a): one frame
// through the K reversed flow steps, the gates that do not depend on the
// chain (gc, gh: sample_gates.cuh) given. For chain position i = 0 .. K-1,
// step k = K-1-i, on BT rows:
//   gi     = gc[k] + z[:, :Z1] @ w_ih_t[k][:Z1]
//   h      = GRU(gi, gh[k], h_prev[k])             (gate order r, z, n)
//   hout   = h @ out_w_t[k] + out_b[k]             ([shift | scale_raw] halves)
//   z2     = z2 / max(sigmoid(scale_raw + 2), eps) - shift
//   z      = (z @ W^-1[k]) * exp(-logs[k]) - bias[k]
// and writes x = z, the K new states and, for the sequence kernel, the
// next own-face history (the oldest frame dropped, x appended).
//
// Replaces: the serial part of lets_face_it_tpu/ops/pallas_flow.py::_kernel
// and ::_seq_rev_kernel (their step bodies, the K reversed steps of a frame).
//
// What bounds it on an H100: the chain's weights are 84.9 KB a step for
// final_model (w_ih_t[k][:Z1], out_w_t[k], out_b[k], W^-1[k], the actnorm),
// 1.36 MB for K = 16, and 21 kFLOP a row and step, serial over the K steps.
// Read from L2 by one SM each step, as the first version of this kernel did,
// the weights cost about 1.5 us a step. Held in shared memory, a step is
// bound by latency: three dependent products and their pointwise work, a
// block barrier after each (PERF.md: about 2.2 us a step on one SM at one
// row, measured by the trace below).
//
// Design: a thread-block cluster of CS blocks holds all K steps' chain
// weights resident in its blocks' shared memory, the steps split in chain
// order (rank r holds steps [r*K/CS, (r+1)*K/CS)), loaded once per launch
// by one bulk copy (cp.async.bulk) per step that completes on that step's
// mbarrier, so that a block starts its first step as soon as that step has
// arrived. The host lays each step's weights out in the order the lanes
// read them (ChainArgs::weights), so that every shared-memory read of a warp
// is 32 consecutive words. A tile of BT rows enters rank 0, runs its steps
// there and hops to rank 1: the z rows go into the next block's shared
// memory by st.async, which completes the byte count of that block's
// mbarrier for the tile; one barrier per tile, armed once, so no slot is
// reused within a launch (a hop costs about 0.15 us). A cluster takes M
// tiles in turn, so its ranks work as a pipeline (rank r on tile j while
// rank r+1 is on tile j-1), and more rows go to more clusters, each reading
// the weights once. Inside a block the 512 threads split each product (4,
// 16 and 8 lanes an output, the rows interleaved) and sum by warp shuffles;
// every row's gates and previous states are fetched by cp.async ahead of
// the wait for z. The launch overlaps the gates kernel before it
// (programmatic dependent launch): barrier set-up and weight copies run
// while the gates finish, and the kernel waits for them (griddepcontrol)
// only before it reads their results; the cluster barrier that guards the
// first st.async is split into an early arrive and a late wait. Every wait
// traps after 10 s (stream_watchdog) rather than hang the card.
//
// Where the K steps' chain weights do not fit the shared memory of one
// cluster of 8 (at the final widths from H = 256 at K = 16 on: 157 KB a step
// at H = 256, 300 KB at H = 512), the plan first takes a cluster of 16
// (non-portable on an H100; at H = 256, K = 16 each block then holds its one
// step resident). Where a block cannot hold its steps even so (H = 512, or
// K = 32 from H = 256), the plan is the hidden split (below) wherever a
// cluster splits H, else the kernel runs its streaming variant (STREAM):
// every block keeps resident the part of its steps' weights that fits
// (out_w_t[k], out_b[k], W^-1[k] and the actnorm: 128 KB a step at H = 512;
// where even out_w_t does not fit, as at H = 1024 or at H = 512, K = 32, only
// the last three) and streams the rest, w_ih_t[k][:Z1] (172 KB a step at
// H = 512) and, in the second case, out_w_t[k], through a ring of NS slots
// of whole interleaved row groups in the block's remaining shared memory.
// One thread issues the copies (cp.async.bulk, completing on the slot's
// "full" barrier) in the order the block consumes them: the first NS at
// launch, so that they arrive while the earlier ranks compute, and each
// further one as soon as every warp has released the slot it reuses
// ("empty" barrier, one arrival a warp). The product that reads a streamed
// matrix walks its chunks in that order: w_ih's with one GRU unit (two
// from H = 513 on) a thread over all Z1 rows, four rows a 16-byte read,
// and out_w's as the resident lanes do. The ring's depth bounds the bytes
// in flight a block: at H = 512, K = 16, three slots of one 24-KB row group
// each, 72 of a step's 172 KB ahead of the step. The streaming variant gives
// a thread at most two GRU units, so it stops at H = 1,024. The hidden split
// (sample_chain_hsplit.cuh) has no such bound: a cluster of blocks shares
// each step, each block owning a slice of the hidden units and streaming
// only its share of the weights. The plan takes the resident variant
// whenever a cluster of 8, else of 16, holds the weights, else the hidden
// split where the caller laid its weights out for one (ChainArgs::hs_cs;
// ops/flow_kernels.py::chain_placement does so wherever a cluster splits H),
// else the streaming variant (chain_plan); a spec that no plan fits is
// refused. The hidden split read faster than the streaming variant at every
// width where both ran, three probes each (probe_sampling_kernels.py --plan
// hsplit --quick on an H100, C = 56; PERF.md): at B = 1 the chain 0.075 /
// 0.078 ms against 0.125 / 0.197 at K = 16, H = 512 / 1,024, 0.144 against
// 0.210 at K = 32, H = 256; at B = 64 1.4-2.0x. The streaming variant stays
// for a spec that no cluster splits (Z1 not a multiple of 4) and when asked
// for. Its defaults, from probe_sampling_kernels.py --hidden_channels 512
// --expression_dim 48 on an H100 (PERF.md): a cluster of 16 and as many
// slots as fit; at B = 1 the chain read 0.126 ms (2 slots 0.130; out_w_t
// streamed too in a cluster of 8, 2 slots, 0.116, the least: a cluster
// holds 15 such at once, 7 of 16), and at B = 128 a cluster of 16 read
// 0.246-0.315 ms against 0.291-0.390 in clusters of 8.
//
// Included by the launchers (frame_rev.cu, seq_rev.cu, sample_chain.cu).
// Only a library that defines SAMPLE_CHAIN_PROBE before the include
// (sample_chain.cu, which the probe and the checks call) compiles the
// probe's traced instantiation (ChainArgs::trace); the launchers of the main
// paths do not.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "flow_stream.cuh"

// Internal linkage: each launcher library (frame_rev, seq_rev, sample_*)
// keeps its own kernels and its own once-per-device flags; the static
// locals of inline functions would otherwise be one object shared by
// every library loaded into the process.
namespace {

constexpr int CHAIN_THREADS = 512;
constexpr int CHAIN_MAX_HELD = 16;       // steps one block may hold
constexpr int CHAIN_MAX_TILES = 32;      // row tiles per cluster (M)
constexpr int CHAIN_MAX_CLUSTER = 16;    // above 8 non-portable
constexpr int CHAIN_WIDE_CLUSTER = 16;   // where a cluster of 8 cannot hold the weights
constexpr int CHAIN_MAX_SLOTS = 8;       // slots of the streaming variant's ring
// the ring's barriers (full and empty, 8 bytes each a slot), in floats
constexpr int CHAIN_RING_BAR_FLOATS = 4 * CHAIN_MAX_SLOTS;
constexpr int CHAIN_BAR_FLOATS = 2 * (CHAIN_MAX_HELD + CHAIN_MAX_TILES);
constexpr int CHAIN_PARTS_GRU = 4;      // slices of z1 @ w_ih_t[k][:Z1]
constexpr int CHAIN_SLICES_OUT = 16;     // slices of h @ out_w_t[k]
constexpr int CHAIN_SLICES_MIX = 8;      // slices of z @ W^-1[k]
// Used when the caller asks for none (0), the largest portable size:
// measured best on an H100 by lets_face_it_tpu_torch/probe_sampling_kernels.py
// (PERF.md).
constexpr int CHAIN_DEFAULT_CLUSTER = 8;

struct ChainArgs {
  // [K, chain_step_floats] each step's weights in the order of the kernel's
  // lanes (ops/flow_kernels.py::chain_weights lays them out):
  //   w_ih_t[k][:Z1]  as [ceil(Z1/4)][3H][4]   row 4m+p at [m][c][p]
  //   out_w_t[k]      as [ceil(H/16)][COUT][16] row 16m+p at [m][c][p]
  //   out_b[k]        [COUT]
  //   W^-1[k]         as [ceil(C/8)][C][8]      row 8m+p at [m][c][p]
  //   an_bias[k], exp(-logs[k])  [C] each
  // (rows past the end zero, each piece padded to 16 bytes), so that the
  // lanes of a warp read consecutive words.
  const float* weights;
  int K, C, Z1, H, COUT;
  float scale_eps;
  // the frame
  int B, P1;
  const float* z_in;     // [B, C]
  const float* gc;       // [K, B, 3H]
  const float* gh;       // [K, B, 3H]
  const float* states_in;   // [K, B, H]
  float* states_out;        // [K, B, H] (may be states_in)
  float* x_out;             // [B, C]
  const float* hist_in;     // [B, P1] (P1 > 0)
  float* hist_out;          // [B, P1]
  // the plan
  int cs, m, step_floats;
  // null, or (the traced instantiation only, SAMPLE_CHAIN_PROBE)
  // [blocks, CHAIN_TRACE_SLOTS] device times (ns) of the first tile: block
  // start, the gates' results visible, z in hand, the end of each held
  // step, the hand-off sent; in the last two slots the ends of the GRU and
  // the coupling phases of the first held step, and in the two before them
  // the SM's cycle counter at z in hand and at the end of that step (their
  // ratio to the times is the SM clock)
  unsigned long long* trace;
  // the matmul precision (flow_step.cuh::FlowPrecision): the activation
  // operands of the three products are rounded as they are read, the
  // weights come rounded; the traced instantiation takes FLOW_F32 only
  int mode;
  // the streaming variant's plan: out_w_t streamed too, ring slots, floats
  // a slot
  int stream_out, nslots, slot_floats;
  // the hidden split's weights ([K, hs_cs, chain_hs_rank_floats], null where
  // the caller has laid none out) and the cluster they are laid out for (0:
  // none); sample_chain_hsplit.cuh
  const float* hs_weights;
  int hs_cs;
};

constexpr int CHAIN_TRACE_SLOTS = 32;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

// Floats of one step's resident weights (ChainArgs::weights).
__host__ __device__ inline int chain_step_floats(int C, int Z1, int H, int COUT) {
  return round_up(Z1, CHAIN_PARTS_GRU) * 3 * H + round_up(H, CHAIN_SLICES_OUT) * COUT
         + round4(COUT) + round_up(C, CHAIN_SLICES_MIX) * C + 2 * round4(C);
}

// Shared floats of a block holding `held` steps, BT-row tiles, M of them:
// the barriers, the weights (step_floats 0 where they are read from global
// memory), the incoming tiles, two z buffers, the new state, and a tile's
// gates and previous states for the held steps.
__host__ __device__ inline int chain_smem_floats(int held, int step_floats,
                                                 int bt, int m, int C, int H) {
  return CHAIN_BAR_FLOATS + held * step_floats + m * round4(bt * C)
         + 2 * round4(bt * C) + round4(bt * H) + held * bt * 7 * H;
}

// Where a step's resident weights start in the streaming variant: out_w_t
// onwards, or, with out_w_t streamed too, out_b onwards (the block holds
// [r0, chain_step_floats) of each of its steps).
__host__ __device__ inline int chain_stream_r0(int Z1, int H, int COUT, bool stream_out) {
  const int o_wo = round_up(Z1, CHAIN_PARTS_GRU) * 3 * H;
  return stream_out ? o_wo + round_up(H, CHAIN_SLICES_OUT) * COUT : o_wo;
}

// Floats of one streamed chunk unit: a row group of w_ih_t[k][:Z1] (its
// CHAIN_PARTS_GRU interleaved rows) and, with out_w_t streamed, the larger
// of that and a row group of out_w_t; a slot holds whole units.
__host__ __device__ inline int chain_stream_unit(int H, int COUT, bool stream_out) {
  const int gru = CHAIN_PARTS_GRU * 3 * H, out = CHAIN_SLICES_OUT * COUT;
  return stream_out && out > gru ? out : gru;
}

__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// 16 bytes into the shared memory of another block of the cluster,
// completing 16 bytes on its barrier `bar` (both cluster addresses).
__device__ __forceinline__ void st_async_v4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// Wait for phase `parity` of a barrier completed by another block's
// st.async (release at cluster scope), acquiring at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023) == 0) t0 = stream_watchdog(t0);
  }
}

// The two halves of cluster_sync(): every thread of every block arrives,
// and later waits for all the others' arrivals.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// TRACE: the probe's instantiation, which records ChainArgs::trace; the
// main paths launch TRACE = false, which compiles no timestamp. MODE:
// ChainArgs::mode. STREAM: the streaming variant (the held steps' weights
// partly resident, the rest through the ring); else all of them are copied
// into shared memory once a launch.
template <int BT, bool TRACE, int MODE, bool STREAM>
__global__ void __launch_bounds__(CHAIN_THREADS, 1)
sample_chain_kernel(ChainArgs a) {
  extern __shared__ __align__(128) float csm[];
  const int tid = threadIdx.x;
  const int K = a.K, C = a.C, Z1 = a.Z1, H = a.H, COUT = a.COUT;
  const int G = 3 * H, half = COUT / 2;
  const int ZQ = (Z1 + CHAIN_PARTS_GRU - 1) / CHAIN_PARTS_GRU;
  const int HQ = (H + CHAIN_SLICES_OUT - 1) / CHAIN_SLICES_OUT;
  const int CQ = (C + CHAIN_SLICES_MIX - 1) / CHAIN_SLICES_MIX;
  const int cs = a.cs, M = a.m, SF = a.step_floats;
  const uint32_t rank = cluster_rank();
  const int i0 = (int)rank * K / cs, i1 = ((int)rank + 1) * K / cs;
  const int held = i1 - i0;
  const int crow0 = (int)(blockIdx.x / cs) * M * BT;
  unsigned long long* trace = TRACE && a.trace && tid == 0
                                  ? a.trace + (size_t)blockIdx.x * CHAIN_TRACE_SLOTS
                                  : nullptr;
  if (TRACE && trace) trace[0] = global_ns();

  // offsets in a step's weights
  const int o_wo = ZQ * CHAIN_PARTS_GRU * G, o_ob = o_wo + HQ * CHAIN_SLICES_OUT * COUT,
            o_wi = o_ob + round4(COUT), o_ab = o_wi + CQ * CHAIN_SLICES_MIX * C,
            o_am = o_ab + round4(C);
  // the part of a step held in shared memory: [r0, SF)
  const bool stream_out = STREAM && a.stream_out;
  const int r0 = STREAM ? chain_stream_r0(Z1, H, COUT, stream_out) : 0;
  const int RF = SF - r0;

  const uint32_t bars = smem_u32(csm);
  const uint32_t wbar = bars;                             // [held]
  const uint32_t zbar = bars + 8 * CHAIN_MAX_HELD;        // [M]
  float* wts = csm + CHAIN_BAR_FLOATS;                    // [held, RF]
  float* zin = wts + (size_t)held * RF;                   // [M, BT*C]
  const int zstride = round4(BT * C);
  float* zw0 = zin + (size_t)M * zstride;                 // [BT, C]
  float* zw1 = zw0 + zstride;                             // [BT, C]
  float* hb = zw1 + zstride;                              // [BT, H]
  float* pre = hb + round4(BT * H);                       // [held, BT, 2G + H]
  const int PR = 2 * G + H;                               // gc | gh | h_prev
  // the streaming variant's ring: its barriers, then NS slots
  float* ring_bars = pre + (size_t)held * BT * PR;
  float* ring = ring_bars + CHAIN_RING_BAR_FLOATS;        // [NS, SLOT]
  const uint32_t full = smem_u32(ring_bars);              // [NS]
  const uint32_t empty = full + 8 * CHAIN_MAX_SLOTS;      // [NS]
  const int NS = a.nslots, SLOT = a.slot_floats;
  // the chunks the block consumes, in order: for each tile, for each held
  // step, w_ih_t's row groups rz at a time (nz chunks), then, streamed too,
  // out_w_t's ro at a time (no chunks)
  const int ZU = CHAIN_PARTS_GRU * G, OU = CHAIN_SLICES_OUT * COUT;
  const int rz = STREAM ? SLOT / ZU : 1, ro = stream_out ? SLOT / OU : 1;
  const int nz = (ZQ + rz - 1) / rz, no = stream_out ? (HQ + ro - 1) / ro : 0;
  const int per_step = nz + no, per_tile = held * per_step;
  const int tiles = min(M, (a.B - crow0 + BT - 1) / BT);
  const int chunks = STREAM ? tiles * per_tile : 0;
  // chunk n into its slot (one thread)
  auto issue = [&](int n) {
    const int rem = n % per_tile, s = rem / per_step, c = rem % per_step;
    const int k = K - 1 - (i0 + s);
    const float* src = a.weights + (size_t)k * SF;
    int units;
    if (c < nz) {
      src += (size_t)c * rz * ZU;
      units = min(rz, ZQ - c * rz) * ZU;
    } else {
      src += o_wo + (size_t)(c - nz) * ro * OU;
      units = min(ro, HQ - (c - nz) * ro) * OU;
    }
    const int slot = n % NS;
    mbar_arrive_expect_tx(full + 8 * slot, (uint32_t)units * 4u);
    bulk_copy_g2s(smem_u32(ring + (size_t)slot * SLOT), src, (uint32_t)units * 4u,
                  full + 8 * slot);
  };
  // the consumers' side of chunk n: wait for it (all threads) ...
  auto take = [&](int n) -> const float* {
    const int slot = n % NS;
    mbar_wait(full + 8 * slot, (uint32_t)(n / NS) & 1u);
    return ring + (size_t)slot * SLOT;
  };
  // ... and release it: one arrival a warp; the issuing thread refills the
  // slot with chunk n + NS once every warp has released it
  auto give = [&](int n) {
    const int slot = n % NS;
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty + 8 * slot);
    if (tid == 0 && n + NS < chunks) {
      mbar_wait(empty + 8 * slot, (uint32_t)(n / NS) & 1u);
      issue(n + NS);
    }
  };
  int q = 0;   // the next chunk

  if (tid == 0) {
    for (int s = 0; s < held; ++s) mbar_init(wbar + 8 * s, 1);
    for (int j = 0; j < M; ++j) mbar_init(zbar + 8 * j, 1);
    for (int s = 0; STREAM && s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CHAIN_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    // the incoming tiles: each barrier's one arrival, and the bytes expected
    if (rank > 0)
      for (int j = 0; j < M; ++j)
        mbar_arrive_expect_tx(zbar + 8 * j, (uint32_t)(BT * C * 4));
    // this block's steps (their resident part), one bulk copy and one
    // barrier each
    for (int s = 0; s < held; ++s) {
      const int k = K - 1 - (i0 + s);
      const uint32_t bar = wbar + 8 * s;
      mbar_arrive_expect_tx(bar, (uint32_t)RF * 4u);
      bulk_copy_g2s(smem_u32(wts + (size_t)s * RF), a.weights + (size_t)k * SF + r0,
                    (uint32_t)RF * 4u, bar);
    }
    // the ring's first chunks
    for (int c = 0; c < NS && c < chunks; ++c) issue(c);
  }
  __syncthreads();
  // Every block's barriers must be armed before a peer's first st.async into
  // it: arrive now, wait just before this block's first hand-off (by then
  // the peers have long arrived), so rank 0 starts without waiting.
  cluster_arrive();
  bool cluster_waited = false;
  // Launched as a programmatic dependent of the gates kernel, the set-up
  // above overlaps it; nothing it wrote is read before this point.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (TRACE && trace) trace[1] = global_ns();

  for (int j = 0; j < M; ++j) {
    const int row0 = crow0 + j * BT;
    if (row0 >= a.B) break;   // the same for every rank of the cluster
    const int rows = min(BT, a.B - row0);
    // the tile's gates and previous states of the held steps, ahead of the
    // wait for z (zeros past the batch)
    for (int s = 0; s < held; ++s) {
      const int k = K - 1 - (i0 + s);
      float* dst = pre + (size_t)s * BT * PR;
      for (int u = tid; u < BT * PR / 4; u += CHAIN_THREADS) {
        const int r = u / (PR / 4), q4 = 4 * (u - r * (PR / 4));
        const size_t row = (size_t)k * a.B + row0 + min(r, rows - 1);
        const float* src = q4 < G ? a.gc + row * G + q4
                         : q4 < 2 * G ? a.gh + row * G + q4 - G
                         : a.states_in + row * H + q4 - 2 * G;
        cp_async16(dst + r * PR + q4, src, r < rows);
      }
    }
    cp_async_commit();
    float* cur;
    float* nxt;
    if (rank == 0) {
      cur = zw1;
      nxt = zw0;
      for (int idx = tid; idx < BT * C; idx += CHAIN_THREADS)
        cur[idx] = idx / C < rows ? a.z_in[(size_t)row0 * C + idx] : 0.0f;
    } else {
      cur = zin + (size_t)j * zstride;
      nxt = zw0;
      mbar_wait_cluster(zbar + 8 * j, 0);
    }
    cp_async_wait_all();
    __syncthreads();
    if (TRACE && trace && j == 0) {
      trace[2] = global_ns();
      trace[CHAIN_TRACE_SLOTS - 4] = clock64();
    }

    for (int s = 0; s < held; ++s) {
      const int k = K - 1 - (i0 + s);
      // the step's weights, at their offsets within a whole step
      const float* ws = wts + (size_t)s * RF - r0;
      if (j == 0) mbar_wait(wbar + 8 * s, 0);

      if constexpr (STREAM) {
        // h = GRU(gc + z1 @ Wz, gh, h_prev), Wz streamed: a thread holds
        // unit u (and u + CHAIN_THREADS) for all BT rows and all Z1 rows,
        // four rows (one interleaved row group) a 16-byte read
        float acc[2][3][BT];
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int r = 0; r < BT; ++r) acc[p][0][r] = acc[p][1][r] = acc[p][2][r] = 0.0f;
        for (int c = 0; c < nz; ++c, ++q) {
          const float* chunk = take(q);
          const int m0 = c * rz, m1 = min(ZQ, m0 + rz);
          for (int m = m0; m < m1; ++m) {
            const float4* wm = reinterpret_cast<const float4*>(chunk) + (m - m0) * G;
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              const int u = tid + p * CHAIN_THREADS;
              if (u >= H) continue;
              const float4 w0 = wm[u], w1 = wm[H + u], w2 = wm[2 * H + u];
#pragma unroll
              for (int r = 0; r < BT; ++r) {
                const float4 x = round_operand<MODE>(
                    *reinterpret_cast<const float4*>(cur + r * C + CHAIN_PARTS_GRU * m));
                acc[p][0][r] = fmaf(x.x, w0.x, acc[p][0][r]);
                acc[p][0][r] = fmaf(x.y, w0.y, acc[p][0][r]);
                acc[p][0][r] = fmaf(x.z, w0.z, acc[p][0][r]);
                acc[p][0][r] = fmaf(x.w, w0.w, acc[p][0][r]);
                acc[p][1][r] = fmaf(x.x, w1.x, acc[p][1][r]);
                acc[p][1][r] = fmaf(x.y, w1.y, acc[p][1][r]);
                acc[p][1][r] = fmaf(x.z, w1.z, acc[p][1][r]);
                acc[p][1][r] = fmaf(x.w, w1.w, acc[p][1][r]);
                acc[p][2][r] = fmaf(x.x, w2.x, acc[p][2][r]);
                acc[p][2][r] = fmaf(x.y, w2.y, acc[p][2][r]);
                acc[p][2][r] = fmaf(x.z, w2.z, acc[p][2][r]);
                acc[p][2][r] = fmaf(x.w, w2.w, acc[p][2][r]);
              }
            }
          }
          give(q);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int u = tid + p * CHAIN_THREADS;
          if (u >= H) continue;
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            const float* pr = pre + ((size_t)s * BT + r) * PR + u;
            const float rg = sigmoidf_(pr[0] + acc[p][0][r] + pr[G]);
            const float ug = sigmoidf_(pr[H] + acc[p][1][r] + pr[G + H]);
            const float ng = tanhf(pr[2 * H] + acc[p][2][r] + rg * pr[G + 2 * H]);
            const float h = (1.0f - ug) * ng + ug * pr[2 * G];
            hb[r * H + u] = h;
            if (r < rows) a.states_out[((size_t)k * a.B + row0 + r) * H + u] = h;
          }
        }
      } else {
      // h = GRU(gc + z1 @ Wz, gh, h_prev): CHAIN_PARTS_GRU lanes a unit, each
      // an interleaved quarter of the Z1 rows for all BT rows; after the
      // butterfly every lane holds the sums, and lane p finishes rows p, p+4..
      for (int base = 0; base < H * CHAIN_PARTS_GRU; base += CHAIN_THREADS) {
        const int job = base + tid;
        const int part = job % CHAIN_PARTS_GRU, u = job / CHAIN_PARTS_GRU;
        const bool act = u < H;
        float ar[BT], az[BT], an[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) ar[r] = az[r] = an[r] = 0.0f;
        if (act) {
          // rows 4m + part; past Z1 the weights are zero (and z finite)
          const float* wz = ws + u * CHAIN_PARTS_GRU + part;
#pragma unroll 1
          for (int m = 0; m < ZQ; ++m) {
            const float* wm = wz + m * CHAIN_PARTS_GRU * G;
            const float w0 = wm[0], w1 = wm[CHAIN_PARTS_GRU * H],
                        w2 = wm[2 * CHAIN_PARTS_GRU * H];
            const int i = CHAIN_PARTS_GRU * m + part;
#pragma unroll
            for (int r = 0; r < BT; ++r) {
              const float x = round_operand<MODE>(cur[r * C + i]);
              ar[r] = fmaf(x, w0, ar[r]);
              az[r] = fmaf(x, w1, az[r]);
              an[r] = fmaf(x, w2, an[r]);
            }
          }
        }
#pragma unroll
        for (int off = 1; off < CHAIN_PARTS_GRU; off *= 2)
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            ar[r] += __shfl_xor_sync(0xffffffffu, ar[r], off);
            az[r] += __shfl_xor_sync(0xffffffffu, az[r], off);
            an[r] += __shfl_xor_sync(0xffffffffu, an[r], off);
          }
        if (act) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            if (r % CHAIN_PARTS_GRU != part) continue;
            const float* p = pre + ((size_t)s * BT + r) * PR + u;
            const float rg = sigmoidf_(p[0] + ar[r] + p[G]);
            const float ug = sigmoidf_(p[H] + az[r] + p[G + H]);
            const float ng = tanhf(p[2 * H] + an[r] + rg * p[G + 2 * H]);
            const float h = (1.0f - ug) * ng + ug * p[2 * G];
            hb[r * H + u] = h;
            if (r < rows) a.states_out[((size_t)k * a.B + row0 + r) * H + u] = h;
          }
        }
      }
      }
      __syncthreads();
      if (TRACE && trace && j == 0 && s == 0) trace[CHAIN_TRACE_SLOTS - 2] = global_ns();

      // hout = h @ out_w_t + out_b, then the coupling: CHAIN_SLICES_OUT lanes
      // a pair (shift jj, scale jj), each a slice of H for all BT rows; lane
      // r finishes row r. Streamed, out_w_t comes in chunks of ro row groups
      // (the plan keeps the pairs to one pass: CHAIN_SLICES_OUT * COUT / 2 <=
      // CHAIN_THREADS).
      const float* ob = ws + o_ob;
      for (int base = 0; base < half * CHAIN_SLICES_OUT; base += CHAIN_THREADS) {
        const int job = base + tid;
        const int sl = job % CHAIN_SLICES_OUT, jj = job / CHAIN_SLICES_OUT;
        const bool act = jj < half;
        float sh[BT], sc[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) sh[r] = sc[r] = 0.0f;
        if (stream_out) {
          for (int c = 0; c < no; ++c, ++q) {
            const float* chunk = take(q);
            if (act) {
              // rows 16m + sl of the chunk's row groups [m0, m1)
              const float* wj = chunk + jj * CHAIN_SLICES_OUT + sl;
              const int m0 = c * ro, m1 = min(HQ, m0 + ro);
#pragma unroll 1
              for (int m = m0; m < m1; ++m) {
                const int i = CHAIN_SLICES_OUT * m + sl;
                const float* wm = wj + (m - m0) * CHAIN_SLICES_OUT * COUT;
                const float w0 = wm[0], w1 = wm[CHAIN_SLICES_OUT * half];
#pragma unroll
                for (int r = 0; r < BT; ++r) {
                  const float hv = i < H ? round_operand<MODE>(hb[r * H + i]) : 0.0f;
                  sh[r] = fmaf(hv, w0, sh[r]);
                  sc[r] = fmaf(hv, w1, sc[r]);
                }
              }
            }
            give(q);
          }
        } else if (act) {
          // rows 16m + sl
          const float* wj = ws + o_wo + jj * CHAIN_SLICES_OUT + sl;
#pragma unroll 1
          for (int m = 0; m < HQ; ++m) {
            const int i = CHAIN_SLICES_OUT * m + sl;
            const float* wm = wj + m * CHAIN_SLICES_OUT * COUT;
            const float w0 = wm[0], w1 = wm[CHAIN_SLICES_OUT * half];
#pragma unroll
            for (int r = 0; r < BT; ++r) {
              const float hv = i < H ? round_operand<MODE>(hb[r * H + i]) : 0.0f;
              sh[r] = fmaf(hv, w0, sh[r]);
              sc[r] = fmaf(hv, w1, sc[r]);
            }
          }
        }
#pragma unroll
        for (int off = 1; off < CHAIN_SLICES_OUT; off *= 2)
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            sh[r] += __shfl_xor_sync(0xffffffffu, sh[r], off);
            sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
          }
        if (act) {
#pragma unroll
          for (int r = 0; r < BT; ++r) {
            if (r != sl) continue;
            const float shift = sh[r] + ob[jj];
            const float scale = fmaxf(sigmoidf_(sc[r] + ob[half + jj] + 2.0f),
                                      a.scale_eps);
            float* z2 = cur + r * C + Z1 + jj;
            *z2 = *z2 / scale - shift;
          }
        }
      }
      __syncthreads();
      if (TRACE && trace && j == 0 && s == 0) trace[CHAIN_TRACE_SLOTS - 1] = global_ns();

      // z = (z @ W^-1) * exp(-logs) - bias: CHAIN_SLICES_MIX lanes a column,
      // each a slice of C for all BT rows; lane r finishes row r
      const float* wi = ws + o_wi;
      const float* ab = ws + o_ab;
      const float* am = ws + o_am;
      for (int base = 0; base < C * CHAIN_SLICES_MIX; base += CHAIN_THREADS) {
        const int job = base + tid;
        const int sl = job % CHAIN_SLICES_MIX, c = job / CHAIN_SLICES_MIX;
        const bool act = c < C;
        float v[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) v[r] = 0.0f;
        if (act) {
          // rows 8m + sl
          const float* wc = wi + c * CHAIN_SLICES_MIX + sl;
#pragma unroll 1
          for (int m = 0; m < CQ; ++m) {
            const int i = CHAIN_SLICES_MIX * m + sl;
            const float w = wc[m * CHAIN_SLICES_MIX * C];
#pragma unroll
            for (int r = 0; r < BT; ++r)
              v[r] = fmaf(i < C ? round_operand<MODE>(cur[r * C + i]) : 0.0f, w,
                          v[r]);
          }
        }
#pragma unroll
        for (int off = 1; off < CHAIN_SLICES_MIX; off *= 2)
#pragma unroll
          for (int r = 0; r < BT; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], off);
        if (act) {
#pragma unroll
          for (int r = 0; r < BT; ++r)
            if (r == sl) nxt[r * C + c] = v[r] * am[c] - ab[c];
        }
      }
      __syncthreads();
      if (TRACE && trace && j == 0) {
        trace[3 + s] = global_ns();
        if (s == 0) trace[CHAIN_TRACE_SLOTS - 3] = clock64();
      }
      float* done = nxt;   // this tile's slot is its own: free to reuse
      nxt = cur;
      cur = done;
    }

    if ((int)rank + 1 < cs) {
      if (!cluster_waited) {
        cluster_wait();   // the next rank's barriers are armed
        cluster_waited = true;
      }
      // hand the tile to the next rank
      const uint32_t dst = map_rank(smem_u32(zin + (size_t)j * zstride), rank + 1);
      const uint32_t bar = map_rank(zbar + 8 * j, rank + 1);
      for (int q4 = tid; q4 < BT * C / 4; q4 += CHAIN_THREADS)
        st_async_v4(dst + 16 * q4, reinterpret_cast<const float4*>(cur)[q4], bar);
      if (TRACE && trace && j == 0) trace[3 + held] = global_ns();
    } else {
      for (int idx = tid; idx < rows * C; idx += CHAIN_THREADS)
        a.x_out[(size_t)row0 * C + idx] = cur[idx];
      const int P1 = a.P1;
      for (int idx = tid; idx < rows * P1; idx += CHAIN_THREADS) {
        const int r = idx / P1, q1 = idx - r * P1;
        a.hist_out[(size_t)row0 * P1 + idx] =
            q1 < P1 - C ? a.hist_in[(size_t)row0 * P1 + idx + C]
                        : cur[r * C + q1 - (P1 - C)];
      }
    }
    __syncthreads();   // cur and the work buffers are free for the next tile
  }
  if (!cluster_waited) cluster_wait();
  cluster_sync();   // no block leaves while a peer may still write to it
}

}  // namespace

#include "sample_chain_hsplit.cuh"

namespace {

// ---------------------------------------------------------------------------
// Host side: the launch plan
// ---------------------------------------------------------------------------

// Where a plan keeps the steps' weights (ChainPlan::place): all of them
// resident, or the streaming variant with w_ih_t streamed, or with w_ih_t
// and out_w_t streamed, or the hidden split (sample_chain_hsplit.cuh: each
// block of a cluster streams its units' share of every step).
enum ChainPlace { CHAIN_PLACE_RESIDENT = 0, CHAIN_PLACE_STREAM = 1,
                  CHAIN_PLACE_STREAM_OUT = 2, CHAIN_PLACE_HSPLIT = 3 };

struct ChainPlan {
  int bt;           // rows per tile
  int cs;           // blocks per cluster
  int m;            // tiles per cluster
  int clusters;
  int step_floats;
  int smem_bytes;
  bool resident;    // place == CHAIN_PLACE_RESIDENT
  int place;        // ChainPlace
  int nslots;       // the streaming variant's (or the hidden split's) ring: slots
  int slot_floats;  // and floats a slot
  StreamTable table;   // the hidden split's products (flow_stream.cuh)
};

// The shared memory (bytes) of a block of `place` holding its steps for
// BT-row tiles, M of them, in a cluster of cs; the streaming variant's ring
// takes the rest of max_smem, *nslots slots of *slot floats (slots_req, or
// 0 for as many as fit, at most CHAIN_MAX_SLOTS; each of whole chunk
// units). False if the block does not fit (the ring: fewer than two slots)
// or the variant does not take the shape: one or two GRU units a thread,
// the coupling's pairs in one pass, at most 4 rows a tile.
inline bool chain_block(int K, int C, int Z1, int H, int COUT, int bt, int cs,
                        int m, int place, int slots_req, int max_smem, int* smem,
                        int* nslots, int* slot) {
  const int held = (K + cs - 1) / cs;
  const int SF = chain_step_floats(C, Z1, H, COUT);
  *nslots = *slot = 0;
  if (place == CHAIN_PLACE_RESIDENT) {
    *smem = 4 * chain_smem_floats(held, SF, bt, m, C, H);
    return *smem <= max_smem;
  }
  const bool out = place == CHAIN_PLACE_STREAM_OUT;
  if (H > 2 * CHAIN_THREADS || CHAIN_SLICES_OUT * (COUT / 2) > CHAIN_THREADS || bt > 4)
    return false;
  const int fixed = chain_smem_floats(held, SF - chain_stream_r0(Z1, H, COUT, out),
                                      bt, m, C, H) + CHAIN_RING_BAR_FLOATS;
  const int unit = chain_stream_unit(H, COUT, out);
  const int avail = max_smem / 4 - fixed;
  int n = avail > 0 ? avail / unit : 0;
  if (n > CHAIN_MAX_SLOTS) n = CHAIN_MAX_SLOTS;
  if (slots_req) {
    if (slots_req > n) return false;
    n = slots_req;
  }
  if (n < 2) return false;
  *nslots = n;
  *slot = avail / n / 4 * 4;
  *smem = 4 * (fixed + n * *slot);
  return true;
}

// Where the weights go, as a launcher's caller asks: the plan's choice,
// all resident in shared memory, the streaming variant, or the hidden split.
enum ChainWeights { CHAIN_WEIGHTS_AUTO = 0, CHAIN_WEIGHTS_SHARED = 1,
                    CHAIN_WEIGHTS_STREAMED = 2, CHAIN_WEIGHTS_HSPLIT = 3 };

// The hidden split's cost of a wave of clusters at 1, 2, 4 and 8 rows a
// tile, relative to one row: the chain's time a wave on an H100 (80GB HBM3,
// 700 W; probe_sampling_kernels.py --plan hsplit, H = 1,152, K = 16, B=64 in
// clusters of 16: 0.081, 0.092, 0.104, 0.169 ms; PERF.md).
constexpr float CHAIN_HS_WAVE_COST[4] = {1.0f, 1.12f, 1.3f, 2.2f};

// The hidden split's plan for B rows in a cluster of cs
// (sample_chain_hsplit.cuh): bt rows a tile as asked, else of 1, 2, 4 and 8
// those whose block fits, the one of the least CHAIN_HS_WAVE_COST times the
// waves its clusters take (the clusters the device holds at once are a
// wave); one tile a cluster; the ring's slots as asked (0:
// STREAM_DEFAULT_SLOTS). False if no block fits or the device holds no
// cluster of it.
template <typename Resident>
inline bool chain_hs_plan(int B, int C, int Z1, int H, int COUT, int bt_req,
                          int cs, int slots_req, const FlowDevice& d,
                          Resident resident, ChainPlan* plan) {
  bool found = false;
  float best = 0.0f;
  for (int bt = bt_req ? bt_req : 1; bt <= (bt_req ? bt_req : FLOW_MAX_BT); bt *= 2) {
    const int i = bt >= 8 ? 3 : bt >= 4 ? 2 : bt >= 2 ? 1 : 0;
    StreamPlan sp;
    if (!chain_hs_block(B, C, Z1, H, COUT, bt, cs, slots_req, d, &sp)) break;
    ChainPlan p = {};
    p.bt = bt;
    p.cs = cs;
    p.m = 1;
    p.clusters = sp.blocks / cs;
    p.step_floats = chain_hs_rank_floats(C, Z1, H / cs, COUT);
    p.smem_bytes = sp.smem_bytes;
    p.resident = false;
    p.place = CHAIN_PLACE_HSPLIT;
    p.nslots = sp.nslots;
    p.slot_floats = sp.slot_floats;
    p.table = sp.table;
    const int n = resident(p);
    if (n <= 0) break;
    const float cost = (float)((p.clusters + n - 1) / n) * CHAIN_HS_WAVE_COST[i];
    if (!found || cost < best) {
      *plan = p;
      best = cost;
      found = true;
    }
  }
  return found;
}

// Plans a launch for B rows: bt, cs, m and the streaming variant's ring
// slots as asked, 0 for the defaults; the weights where `place`
// (ChainWeights) asks, by default resident in a cluster of
// CHAIN_DEFAULT_CLUSTER (or K if that is less) where a block of one row of
// the plan holds its steps' weights, else resident in a cluster of
// CHAIN_WIDE_CLUSTER (or K), else the hidden split in the cluster hs_cs the
// caller laid its weights out for (chain_hs_plan; 0: none, and a cs asked
// for must be it), else the streaming variant in a cluster of
// CHAIN_WIDE_CLUSTER (or K), with w_ih_t streamed, else with out_w_t
// streamed too (a cs asked for replaces both clusters). A default tile is
// one row (a tile's steps take about as long for one row as for a few, and
// a cluster pipelines its tiles), doubled (to 8 rows resident, 4
// streaming; the hidden split scores its own, chain_hs_plan) while the
// rows would need more than CHAIN_MAX_TILES tiles in each of the clusters
// the device holds at once (`resident(plan)`); the default m is the least
// that lets every cluster be resident at once. The placement is decided at one row, so every B of a
// spec runs the same one. Returns false if no block fits, a value is out of
// range, or the device holds no cluster of the plan: there is no other plan
// to fall back on.
template <typename Resident>
inline bool chain_plan(int B, int K, int C, int Z1, int H, int COUT,
                       int bt_req, int cs_req, int m_req, int slots_req, int place,
                       int hs_cs, const FlowDevice& d, Resident resident,
                       ChainPlan* plan) {
  if (cs_req < 0 || cs_req > CHAIN_MAX_CLUSTER || bt_req < 0 || bt_req > FLOW_MAX_BT
      || m_req < 0 || m_req > CHAIN_MAX_TILES || slots_req < 0
      || slots_req > CHAIN_MAX_SLOTS || hs_cs < 0
      || place < CHAIN_WEIGHTS_AUTO || place > CHAIN_WEIGHTS_HSPLIT)
    return false;
  int narrow = cs_req ? cs_req : CHAIN_DEFAULT_CLUSTER;
  int wide = cs_req ? cs_req : CHAIN_WIDE_CLUSTER;
  if (narrow > K) narrow = K;
  if (wide > K) wide = K;
  struct Candidate { int cs, place; } cands[5];
  int n_cands = 0;
  if (place == CHAIN_WEIGHTS_AUTO || place == CHAIN_WEIGHTS_SHARED) {
    cands[n_cands++] = {narrow, CHAIN_PLACE_RESIDENT};
    if (wide != narrow) cands[n_cands++] = {wide, CHAIN_PLACE_RESIDENT};
  }
  if ((place == CHAIN_WEIGHTS_AUTO || place == CHAIN_WEIGHTS_HSPLIT) && hs_cs > 0
      && (cs_req == 0 || cs_req == hs_cs))
    cands[n_cands++] = {hs_cs, CHAIN_PLACE_HSPLIT};
  if (place == CHAIN_WEIGHTS_AUTO || place == CHAIN_WEIGHTS_STREAMED) {
    cands[n_cands++] = {wide, CHAIN_PLACE_STREAM};
    cands[n_cands++] = {wide, CHAIN_PLACE_STREAM_OUT};
  }
  int bt = bt_req ? bt_req : 1;
  const int m0 = m_req ? m_req : 1;
  bool found = false;
  for (int i = 0; i < n_cands && !found; ++i) {
    const int cs = cands[i].cs;
    if (cands[i].place == CHAIN_PLACE_HSPLIT) {
      StreamPlan sp;
      found = m0 == 1 && chain_hs_block(1, C, Z1, H, COUT, bt, cs, slots_req, d, &sp);
    } else if (cs >= 1 && (K + cs - 1) / cs <= CHAIN_MAX_HELD) {
      found = chain_block(K, C, Z1, H, COUT, bt, cs, m0, cands[i].place, slots_req,
                          d.max_smem, &plan->smem_bytes, &plan->nslots,
                          &plan->slot_floats);
    }
    if (found) {
      plan->cs = cs;
      plan->place = cands[i].place;
    }
  }
  if (!found) return false;
  if (plan->place == CHAIN_PLACE_HSPLIT)
    return chain_hs_plan(B, C, Z1, H, COUT, bt_req, plan->cs, slots_req, d, resident,
                         plan);
  plan->resident = plan->place == CHAIN_PLACE_RESIDENT;
  plan->bt = bt;
  plan->step_floats = chain_step_floats(C, Z1, H, COUT);
  plan->m = m0;
  plan->clusters = ((B + bt - 1) / bt + plan->m - 1) / plan->m;
  if (m_req == 0) {
    const int n = resident(*plan);
    if (n <= 0) return false;
    const int max_bt = plan->resident ? FLOW_MAX_BT : 4;
    if (bt_req == 0)
      while (bt < max_bt && (B + bt - 1) / bt > n * CHAIN_MAX_TILES) bt *= 2;
    const int tiles = (B + bt - 1) / bt;
    int m = (tiles + n - 1) / n;
    if (m > CHAIN_MAX_TILES) m = CHAIN_MAX_TILES;
    plan->bt = bt;
    plan->m = m;
    plan->clusters = (tiles + m - 1) / m;
    if (!chain_block(K, C, Z1, H, COUT, bt, plan->cs, m, plan->place, slots_req,
                     d.max_smem, &plan->smem_bytes, &plan->nslots,
                     &plan->slot_floats))
      return false;
  }
  return true;
}

// The kernel's shared-memory cap and its permission for clusters above 8,
// once per device.
template <typename Kernel>
inline cudaError_t chain_allow(Kernel kernel, const FlowDevice& d, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < FLOW_MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d.max_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < FLOW_MAX_DEVICES) done[dev] = true;
  return err;
}

// attr: room for two attributes; `after_gates`: launch as a programmatic
// dependent of the kernel before it on the stream (the gates), so that its
// set-up overlaps that kernel (the kernel waits for it before reading).
inline cudaLaunchConfig_t chain_config(const ChainPlan& p, cudaStream_t stream,
                                       cudaLaunchAttribute* attr,
                                       bool after_gates = false) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * p.cs);
  cfg.blockDim = dim3(p.place == CHAIN_PLACE_HSPLIT ? STREAM_THREADS : CHAIN_THREADS);
  cfg.dynamicSmemBytes = p.smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = after_gates ? 2 : 1;
  return cfg;
}

// Clusters of the plan the device holds at once (cudaOccupancyMaxActiveClusters),
// -1 on an error; `kernel` the plan's (its launch shape is the same at every
// mode).
template <typename Kernel>
inline int chain_clusters(Kernel kernel, bool* allowed, const ChainPlan& p,
                          const FlowDevice& d) {
  if (chain_allow(kernel, d, allowed) != cudaSuccess) return -1;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = chain_config(p, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

template <int BT>
inline int chain_resident_place(const ChainPlan& p, const FlowDevice& d) {
  static bool allowed[3][FLOW_MAX_DEVICES] = {};
  if (p.place == CHAIN_PLACE_HSPLIT)
    return chain_clusters(sample_chain_hsplit_kernel<BT, FLOW_F32>, allowed[2], p, d);
  if (p.resident)
    return chain_clusters(sample_chain_kernel<BT, false, FLOW_F32, false>, allowed[0], p, d);
  if constexpr (BT > 4) return -1;   // the streaming variant takes at most 4 rows
  else return chain_clusters(sample_chain_kernel<BT, false, FLOW_F32, true>, allowed[1], p, d);
}

// The same, remembered per device and plan shape, the plans the device
// cannot hold too (the query costs a few microseconds of host time, a push
// plans every frame, and a plan search probes several shapes).
inline int chain_resident_bt(const ChainPlan& p, const FlowDevice& d) {
  struct Entry { int dev, bt, cs, smem, place, n; };
  static Entry cache[64] = {};
  static int filled = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  for (int i = 0; i < filled; ++i) {
    const Entry& e = cache[i];
    if (e.dev == dev && e.bt == p.bt && e.cs == p.cs && e.smem == p.smem_bytes
        && e.place == p.place)
      return e.n;
  }
  int n = -1;
  switch (p.bt) {
    case 1: n = chain_resident_place<1>(p, d); break;
    case 2: n = chain_resident_place<2>(p, d); break;
    case 4: n = chain_resident_place<4>(p, d); break;
    case 8: n = chain_resident_place<8>(p, d); break;
    default: return -1;
  }
  if (filled < 64) cache[filled++] = {dev, p.bt, p.cs, p.smem_bytes, p.place, n};
  return n;
}

inline bool chain_plan_for(int B, const ChainArgs& a, int bt, int cs, int m,
                           int slots, int place, const FlowDevice& d,
                           ChainPlan* plan) {
  return chain_plan(B, a.K, a.C, a.Z1, a.H, a.COUT, bt, cs, m, slots, place,
                    a.hs_weights ? a.hs_cs : 0, d,
                    [&](const ChainPlan& p) { return chain_resident_bt(p, d); },
                    plan);
}

inline bool chain_valid(const ChainArgs& a) {
  return a.B >= 1 && a.K >= 1 && a.C % 4 == 0 && a.H % 4 == 0 && a.COUT % 4 == 0
         && a.COUT == 2 * (a.C - a.Z1) && a.Z1 >= 1
         && round_up(a.Z1, CHAIN_PARTS_GRU) <= a.C
         && (a.P1 == 0 || (a.P1 >= a.C && a.P1 % 4 == 0))
         && precision_valid(a.mode) && a.hs_cs >= 0;
}

template <int BT, bool TRACE, int MODE, bool STREAM>
inline cudaError_t chain_launch_bt(const cudaLaunchConfig_t& cfg, const ChainArgs& a,
                                   const FlowDevice& d) {
  static bool allowed[FLOW_MAX_DEVICES] = {};
  const auto kernel = sample_chain_kernel<BT, TRACE, MODE, STREAM>;
  cudaError_t err = chain_allow(kernel, d, allowed);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int BT, bool TRACE, int MODE>
inline cudaError_t chain_launch_place(const cudaLaunchConfig_t& cfg,
                                      const ChainArgs& a, const ChainPlan& p,
                                      const FlowDevice& d) {
  // the traced kernel is the resident one's
  if constexpr (TRACE) {
    if (!p.resident) return (cudaError_t)FLOW_ERR_PLAN;
    return chain_launch_bt<BT, true, MODE, false>(cfg, a, d);
  } else {
    if (p.place == CHAIN_PLACE_HSPLIT) return chain_hs_launch<BT, MODE>(cfg, a, p.table, d);
    if (p.resident) return chain_launch_bt<BT, false, MODE, false>(cfg, a, d);
    // the streaming variant takes at most 4 rows a tile
    if constexpr (BT > 4) return (cudaError_t)FLOW_ERR_PLAN;
    else return chain_launch_bt<BT, false, MODE, true>(cfg, a, d);
  }
}

template <int BT, bool TRACE>
inline cudaError_t chain_launch_mode(const cudaLaunchConfig_t& cfg,
                                     const ChainArgs& a, const ChainPlan& p,
                                     const FlowDevice& d) {
  if constexpr (TRACE) {
    if (a.mode != FLOW_F32) return (cudaError_t)FLOW_ERR_ARGS;
    return chain_launch_place<BT, true, FLOW_F32>(cfg, a, p, d);
  } else {
    switch (a.mode) {
      case FLOW_F32: return chain_launch_place<BT, false, FLOW_F32>(cfg, a, p, d);
      case FLOW_TF32: return chain_launch_place<BT, false, FLOW_TF32>(cfg, a, p, d);
      case FLOW_BF16: return chain_launch_place<BT, false, FLOW_BF16>(cfg, a, p, d);
      default: return (cudaError_t)FLOW_ERR_ARGS;
    }
  }
}

template <bool TRACE>
inline cudaError_t chain_launch(const cudaLaunchConfig_t& cfg, const ChainArgs& a,
                                const ChainPlan& p, const FlowDevice& d) {
  switch (p.bt) {
    case 1: return chain_launch_mode<1, TRACE>(cfg, a, p, d);
    case 2: return chain_launch_mode<2, TRACE>(cfg, a, p, d);
    case 4: return chain_launch_mode<4, TRACE>(cfg, a, p, d);
    case 8: return chain_launch_mode<8, TRACE>(cfg, a, p, d);
    default: return (cudaError_t)FLOW_ERR_PLAN;
  }
}

// One launch of the chain for one frame on `stream`, added to launches[0]
// and, on the hidden split, to launches[2]; `a` carries the frame's
// pointers, the plan its shape; `after_gates` as in chain_config. A trace is
// taken only by the probe's library.
inline cudaError_t chain_enqueue(ChainArgs a, const ChainPlan& p,
                                 const FlowDevice& d, cudaStream_t stream,
                                 int* launches, bool after_gates = false) {
  a.cs = p.cs;
  a.m = p.m;
  a.step_floats = p.step_floats;
  a.stream_out = p.place == CHAIN_PLACE_STREAM_OUT;
  a.nslots = p.nslots;
  a.slot_floats = p.slot_floats;
  if (p.place == CHAIN_PLACE_HSPLIT) {
    if (!a.hs_weights || a.hs_cs != p.cs) return (cudaError_t)FLOW_ERR_PLAN;
    a.weights = a.hs_weights;
  }
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = chain_config(p, stream, attr, after_gates);
#ifdef SAMPLE_CHAIN_PROBE
  cudaError_t err = a.trace ? chain_launch<true>(cfg, a, p, d)
                            : chain_launch<false>(cfg, a, p, d);
#else
  if (a.trace) return (cudaError_t)FLOW_ERR_ARGS;
  cudaError_t err = chain_launch<false>(cfg, a, p, d);
#endif
  if (err != cudaSuccess) return err;
  ++launches[0];
  if (p.place == CHAIN_PLACE_HSPLIT) ++launches[2];
  return cudaGetLastError();
}

}  // namespace

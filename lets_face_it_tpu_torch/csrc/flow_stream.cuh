// Weight streaming for the serial training kernels (seq_fwd.cu, seq_bwd.cu):
// a ring of shared-memory slots that one producer warp per block fills with
// the weight rows of each tile product, in the order the products run, while
// the consumer warps compute; the blocks of a thread-block cluster share
// every chunk through multicast bulk copies.
//
// Why: the serial chain walks N * K steps, and every step reads the step's
// weights (281 KB for final_model once the conditioning product is done
// ahead by cond_gates.cu) for a few batch rows. Read through L2 by every
// block, as the first version of these kernels did, that is one read of
// the weight set per block and step, issued only when the chain reaches it. The order
// in which the weights are needed does not depend on the data, so here the
// producer runs up to a ring's worth of chunks ahead of the consumers, and each
// chunk is read from L2 once per cluster: block `rank` of a cluster of CS
// blocks copies the rank-th piece of the chunk into the same slot of every
// block of the cluster (cp.async.bulk ... .multicast::cluster), which
// completes the transaction count of each block's "full" barrier.
//
// Slot reuse: a slot is refilled only when the consumers of every block of
// the cluster are done with it. Each consumer warp arrives on its block's
// "consumed" barrier; the producer waits on it and forwards the release to
// the "empty" barrier of every block of the cluster (remote arrive), then
// waits on its own "empty" barrier, which completes once all CS producers
// have forwarded. Every block, padding blocks included, consumes every
// chunk, and every block's piece of every chunk is non-empty (the launcher
// checks it with stream_min_piece_units), so no barrier can run a phase
// ahead of another block.
//
// A tile product out[BT, NC] = X[BT, IN] @ Wt[IN, NC] streams Wt in chunks
// of whole rows (rows are contiguous, so a chunk is one contiguous range of
// bytes). A consumer thread owns four neighbouring output columns (one
// float4 per weight row) of one slice of each chunk's rows, walks its rows
// four at a time with one 16-byte read of X per batch row, keeps the BT
// partial sums in registers across the chunks, and the slices meet in
// shared memory. The split of every product (slices, rows per chunk) is
// planned on the host (StreamTable), so the products divide by nothing.
//
// The chain's other inputs (each step's small vectors, and the per-row
// inputs such as gc or the backward's residuals) are fetched one step ahead
// by the consumers themselves with cp.async (prefetch_units) into a double
// buffer, so no global-memory latency sits on the chain either.
//
// The hidden-split plan (seq_fwd_hsplit.cu, seq_bwd_hsplit.cu) shares a
// tile's rows over the CS blocks of a cluster, each block owning H / CS of
// the hidden units: each block streams only its own weight columns, so its
// ring is filled from global memory for itself alone (produce_local), and
// the blocks meet once or twice a step through the cluster exchange below
// (Exchange: every block's partial sums pushed into every peer's shared
// memory by st.async, completing the peer's mbarrier).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "flow_step.cuh"

// 12 consumer warps and one producer warp: fewer threads than the SM holds,
// so that each keeps its sums in registers (no spills) and the fixed work of
// every product (waits, epilogue) is repeated by fewer warps (PERF.md).
constexpr int STREAM_THREADS = 416;
constexpr int STREAM_CONSUMERS = STREAM_THREADS - 32;   // the last warp produces
constexpr int STREAM_CONSUMER_WARPS = STREAM_CONSUMERS / 32;
constexpr int STREAM_MAX_SLOTS = 16;
constexpr int STREAM_MAX_SLOT_FLOATS = 12 * 1024;       // 48 KB a slot
constexpr int STREAM_MAX_CLUSTER = 8;                   // portable limit
// The hidden-split plan's clusters go up to the non-portable 16.
constexpr int HSPLIT_MAX_CLUSTER = 16;
// Floats at the start of the dynamic shared memory that hold the barriers
// (3 per slot, 8 bytes each), padded to 128 bytes.
constexpr int STREAM_BAR_FLOATS = 96;
static_assert(STREAM_MAX_SLOTS * 3 * 2 <= STREAM_BAR_FLOATS, "barrier area");

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers, cluster, bulk copy
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Arrive on the barrier at offset `bar` in the shared memory of the
// cluster's block `rank`. Default semantics (release at CTA scope), as
// CUTLASS's ClusterBarrier::arrive: the releasing thread's own reads of the
// slot are long done (it forwards its consumers' arrivals), and the
// release.cluster form costs about a microsecond an arrive on an H100.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(bar), "r"(rank));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(remote)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait that lasts this long means a broken schedule: trap (the launch
// fails with an error) rather than hang the device.
constexpr uint64_t STREAM_WATCHDOG_NS = 10ull * 1000 * 1000 * 1000;

// Called every 1024 spins of a wait that started at t0 (0: not yet read);
// returns the start.
__device__ __forceinline__ uint64_t stream_watchdog(uint64_t t0) {
  const uint64_t now = global_ns();
  if (t0 == 0) return now;
  if (now - t0 > STREAM_WATCHDOG_NS) __trap();
  return t0;
}

// Spin until the phase of parity `parity` has completed (CTA scope).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, spins = 0;
  uint64_t t0 = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((++spins & 1023) == 0) t0 = stream_watchdog(t0);
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// The consumer warps only (named barrier 1; the producer warp never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(STREAM_CONSUMERS) : "memory");
}

// `bytes` from global `src` to shared offset `dst` of every block in `mask`,
// completing `bytes` on the barrier at offset `bar` of each of them.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src,
                                                    uint32_t bytes, uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// ---------------------------------------------------------------------------
// The ring
// ---------------------------------------------------------------------------

// Rows of a [*, NC] weight per chunk: a multiple of 4 (the consumers walk
// rows four at a time; every product's IN is a multiple of 4).
__host__ __device__ inline int stream_chunk_rows(int slot_floats, int NC) {
  return slot_floats / NC / 4 * 4;
}

// Number of 16-byte units in the smallest chunk of a product [IN, NC].
__host__ __device__ inline int stream_min_piece_units(int slot_floats, int IN,
                                                      int NC) {
  const int rpc = stream_chunk_rows(slot_floats, NC);
  const int last = (IN - 1) % rpc + 1;
  const int first = rpc < IN ? rpc : IN;
  return (last < first ? last : first) * NC / 4;
}

// Most slices of a product: each output of the epilogue sums one partial
// per slice, one after another, so narrow products (few column groups, many
// idle threads) trade a longer walk over the rows for a short sum.
constexpr int STREAM_MAX_SLICES = 8;

// Slices a product is split into: as many as the consumers allow, at most
// STREAM_MAX_SLICES, one per four rows of a chunk and as many as the
// partial-sum buffer holds.
inline int stream_slices(int IN, int NC, int rpc, int bt, int partial_floats) {
  const int rows = rpc < IN ? rpc : IN;
  int slices = STREAM_CONSUMERS / (NC / 4);
  if (slices > STREAM_MAX_SLICES) slices = STREAM_MAX_SLICES;
  if (slices > rows / 4) slices = rows / 4;
  if (slices * bt * NC > partial_floats) slices = partial_floats / (bt * NC);
  return slices < 1 ? 1 : slices;
}

// The planned split of each product of a kernel's step, in stream order.
constexpr int STREAM_MAX_PRODUCTS = 8;
struct StreamTable {
  int slices[STREAM_MAX_PRODUCTS];
  int rpc[STREAM_MAX_PRODUCTS];          // rows per chunk
  float inv_groups[STREAM_MAX_PRODUCTS];  // 4 / NC, to split ctid without a division
};

// ---------------------------------------------------------------------------
// cp.async prefetch of the chain's inputs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The consumers copy `units` 16-byte units from src (global) to dst
// (shared), the units from `valid` on as zeros (src is not read there;
// `spare` is any valid global address).
__device__ __forceinline__ void prefetch_units(float* dst, const float* src,
                                               int units, int valid,
                                               const float* spare) {
  for (int u = threadIdx.x; u < units; u += STREAM_CONSUMERS)
    cp_async16(dst + 4 * u, u < valid ? src + 4 * u : spare, u < valid);
}

struct Ring {
  float* slots;       // [nslots, slot_floats]
  int nslots;
  int slot_floats;
  uint32_t full;      // barrier arrays, 8 bytes a slot
  uint32_t consumed;
  uint32_t empty;
  int slot;           // this thread's next slot
  uint32_t phase;     // parity of that slot's current use
  bool reused;        // whether the slot held a chunk before
};

// Carves the barriers and the slots from the start of the dynamic shared
// memory; returns the first float after the slots.
__device__ inline float* carve_ring(float* smem, int nslots, int slot_floats,
                                    Ring* ring) {
  const uint32_t bars = smem_u32(smem);
  ring->full = bars;
  ring->consumed = bars + 8 * STREAM_MAX_SLOTS;
  ring->empty = bars + 16 * STREAM_MAX_SLOTS;
  ring->slots = smem + STREAM_BAR_FLOATS;
  ring->nslots = nslots;
  ring->slot_floats = slot_floats;
  ring->slot = 0;
  ring->phase = 0;
  ring->reused = false;
  return ring->slots + (size_t)nslots * slot_floats;
}

__device__ __forceinline__ void advance(Ring& ring) {
  if (++ring.slot == ring.nslots) {
    ring.slot = 0;
    ring.phase ^= 1u;
    ring.reused = true;
  }
}

// One thread initialises the barriers; the caller then synchronises the
// cluster before any block touches a peer's barriers.
__device__ inline void init_ring(const Ring& ring, int cs) {
  for (int s = 0; s < ring.nslots; ++s) {
    mbar_init(ring.full + 8 * s, 1);
    mbar_init(ring.consumed + 8 * s, STREAM_CONSUMER_WARPS);
    mbar_init(ring.empty + 8 * s, cs);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Producer (one thread): streams the rows of Wt [IN, NC] (global, 16-byte
// aligned) through the ring; this block copies its piece of each chunk to
// every block of the cluster.
__device__ inline void produce(Ring& ring, const float* Wt, int IN, int NC,
                               int rpc, uint32_t rank, int cs) {
  const uint16_t mask = (uint16_t)((1u << cs) - 1u);
  for (int c0 = 0; c0 < IN; c0 += rpc) {
    const int rows = min(rpc, IN - c0);
    const uint32_t off = 8 * ring.slot;
    if (ring.reused) {   // the slot's previous chunk: released by every block
      mbar_wait(ring.consumed + off, ring.phase ^ 1u);
      for (int p = 0; p < cs; ++p) mbar_arrive_remote(ring.empty + off, p);
      mbar_wait(ring.empty + off, ring.phase ^ 1u);
    }
    const int units = rows * NC / 4;
    mbar_arrive_expect_tx(ring.full + off, (uint32_t)units * 16u);
    const int u0 = units * (int)rank / cs, u1 = units * ((int)rank + 1) / cs;
    const float* src = Wt + (size_t)c0 * NC + 4 * u0;
    float* dst = ring.slots + (size_t)ring.slot * ring.slot_floats + 4 * u0;
    bulk_copy_multicast(smem_u32(dst), src, (uint32_t)(u1 - u0) * 16u,
                        ring.full + off, mask);
    advance(ring);
  }
}

// `bytes` from global `src` to this block's shared offset `dst`,
// completing `bytes` on the barrier at offset `bar`.
__device__ __forceinline__ void bulk_copy_local(uint32_t dst, const void* src,
                                                uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Producer (one thread) of a ring that no other block shares (the
// hidden-split plan: every block streams its own columns): the rows of
// Wt [IN, NC] into this block's slots. A slot is refilled once this block's
// consumers have released it (init_ring with cs = 1; the "empty" barriers
// are not used).
__device__ inline void produce_local(Ring& ring, const float* Wt, int IN, int NC,
                                     int rpc) {
  for (int c0 = 0; c0 < IN; c0 += rpc) {
    const int rows = min(rpc, IN - c0);
    const uint32_t off = 8 * ring.slot;
    if (ring.reused) mbar_wait(ring.consumed + off, ring.phase ^ 1u);
    const uint32_t bytes = (uint32_t)rows * NC * 4u;
    mbar_arrive_expect_tx(ring.full + off, bytes);
    bulk_copy_local(smem_u32(ring.slots + (size_t)ring.slot * ring.slot_floats),
                    Wt + (size_t)c0 * NC, bytes, ring.full + off);
    advance(ring);
  }
}

// Consumers (all STREAM_CONSUMERS threads, ctid = threadIdx.x):
//   out[r, c] = bias[c] + addend[r * ldd + c] + sum_i X[r, i] * Wt[i, c]
// for the BT rows, Wt streamed through the ring by the matching produce()
// in chunks of rpc rows, split into `slices` (both from the StreamTable).
// X (shared, row stride ldx, 16-byte aligned rows), `bias` and `addend`
// (shared) must be complete on entry; `bias` and `addend` may be null,
// `addend` is read for rows < addend_rows only and may alias `out` element
// for element. Ends with the consumers synchronised and `out` complete.
// MODE (FlowPrecision): X is rounded as it is read; the weights come rounded.
template <int BT, int MODE>
__device__ void stream_matvec(Ring& ring, int IN, int NC, int rpc, int slices,
                              float inv_groups, const float* X, int ldx,
                              const float* bias, const float* addend, int ldd,
                              int addend_rows, float* out, int ldo,
                              float* partial) {
  const int ctid = threadIdx.x;
  const int groups = NC / 4;
  // ctid / groups, exact: (ctid + 0.5) / groups lies 0.5 / groups inside an
  // integer interval, far beyond float rounding for ctid < 1024
  const int sl = __float2int_rz((ctid + 0.5f) * inv_groups);
  const int cg = ctid - sl * groups;
  const bool active = sl < slices;

  float4 acc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int c0 = 0; c0 < IN; c0 += rpc) {
    const int quads = min(rpc, IN - c0) / 4;
    const uint32_t off = 8 * ring.slot;
    mbar_wait(ring.full + off, ring.phase);
    if (active) {
      const float4* wq = reinterpret_cast<const float4*>(
                             ring.slots + (size_t)ring.slot * ring.slot_floats) + cg;
      const float* xq = X + c0;
      for (int q = sl; q < quads; q += slices) {
        const float4 w0 = wq[(4 * q + 0) * groups];
        const float4 w1 = wq[(4 * q + 1) * groups];
        const float4 w2 = wq[(4 * q + 2) * groups];
        const float4 w3 = wq[(4 * q + 3) * groups];
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float4 x = round_operand<MODE>(
              *reinterpret_cast<const float4*>(xq + r * ldx + 4 * q));
          acc[r].x = fmaf(x.x, w0.x, acc[r].x);
          acc[r].y = fmaf(x.x, w0.y, acc[r].y);
          acc[r].z = fmaf(x.x, w0.z, acc[r].z);
          acc[r].w = fmaf(x.x, w0.w, acc[r].w);
          acc[r].x = fmaf(x.y, w1.x, acc[r].x);
          acc[r].y = fmaf(x.y, w1.y, acc[r].y);
          acc[r].z = fmaf(x.y, w1.z, acc[r].z);
          acc[r].w = fmaf(x.y, w1.w, acc[r].w);
          acc[r].x = fmaf(x.z, w2.x, acc[r].x);
          acc[r].y = fmaf(x.z, w2.y, acc[r].y);
          acc[r].z = fmaf(x.z, w2.z, acc[r].z);
          acc[r].w = fmaf(x.z, w2.w, acc[r].w);
          acc[r].x = fmaf(x.w, w3.x, acc[r].x);
          acc[r].y = fmaf(x.w, w3.y, acc[r].y);
          acc[r].z = fmaf(x.w, w3.z, acc[r].z);
          acc[r].w = fmaf(x.w, w3.w, acc[r].w);
        }
      }
    }
    __syncwarp();
    if ((ctid & 31) == 0) mbar_arrive(ring.consumed + off);
    advance(ring);
  }

  if (active) {
    float4* pp = reinterpret_cast<float4*>(partial) + cg;
#pragma unroll
    for (int r = 0; r < BT; ++r) pp[(sl * BT + r) * groups] = acc[r];
  }
  consumer_sync();
  const int stride = BT * NC;
  for (int idx = ctid; idx < stride; idx += STREAM_CONSUMERS) {
    int r = 0, c = idx;
    while (c >= NC) {   // idx / NC, at most BT - 1 steps
      c -= NC;
      ++r;
    }
    float v = bias ? bias[c] : 0.0f;
    if (addend && r < addend_rows) v += addend[r * ldd + c];
    const float* p = partial + idx;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < STREAM_MAX_SLICES; k += 2) {
      if (k < slices) s0 += p[k * stride];
      if (k + 1 < slices) s1 += p[(k + 1) * stride];
    }
    out[r * ldo + c] = v + (s0 + s1);
  }
  consumer_sync();
}

// ---------------------------------------------------------------------------
// The cluster exchange of the hidden-split plan
// ---------------------------------------------------------------------------

// The address `addr` (this block's shared window) in the shared memory of
// the cluster's block `rank`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  return remote;
}

// 16 bytes at cluster address `addr` (another block's shared memory).
__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// 16 bytes into another block's shared memory, completing 16 bytes on its
// barrier `bar` (both cluster addresses; release at cluster scope).
__device__ __forceinline__ void xchg_st_v4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// Spin until the phase of parity `parity` has completed, acquiring at
// cluster scope what the peers' st.async released.
__device__ __forceinline__ void mbar_wait_acquire_cluster(uint32_t bar,
                                                         uint32_t parity) {
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

// One exchange of a cluster of cs blocks: at each use every block sends
// `n` floats (a multiple of 4) to every peer, which keeps them in slot
// `rank` of its receive buffer [cs, n]; the block's own n floats stay where
// they are (the caller reads them there). Uses alternate between two
// buffers and barriers, each armed for the (cs - 1) * n * 4 bytes of the
// peers: a block sends use u + 2 only after it has received every peer's
// use u + 1, which each peer sends only after it has read use u and armed
// that use's barrier again, so neither buffer nor barrier is overwritten
// early. 4 floats of barriers, then the two buffers.
__host__ __device__ inline int xchg_floats(int cs, int n) {
  return 4 + 2 * round4(cs * n);
}

struct Exchange {
  uint32_t bar;   // this block's two barriers, 8 bytes apart
  float* buf;     // [2, round4(cs * n)]
  int n, cs, stride;
};

// Carves an exchange from `at` (16-byte aligned); returns the first float
// after it.
__device__ inline float* carve_xchg(float* at, int cs, int n, Exchange* x) {
  x->bar = smem_u32(at);
  x->buf = at + 4;
  x->n = n;
  x->cs = cs;
  x->stride = round4(cs * n);
  return at + xchg_floats(cs, n);
}

// One thread, before the cluster's first synchronisation: the barriers,
// armed for uses 0 and 1.
__device__ inline void init_xchg(const Exchange& x) {
  for (int i = 0; i < 2; ++i) {
    mbar_init(x.bar + 8 * i, 1);
    mbar_arrive_expect_tx(x.bar + 8 * i, (uint32_t)((x.cs - 1) * x.n * 4));
  }
}

// The consumers: this block's n floats at `src` (shared, complete) into
// slot `rank` of every peer's buffer of use `use`.
__device__ inline void xchg_send(const Exchange& x, int use, const float* src,
                                 uint32_t rank) {
  const int q = x.n / 4, b = use & 1;
  const uint32_t dst0 = smem_u32(x.buf + b * x.stride + rank * x.n);
  const uint32_t bar = x.bar + 8 * b;
  // the block's other writes that peers read after this exchange (its
  // units' states) are ordered before the stores' release
  if ((int)threadIdx.x < (x.cs - 1) * q) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  for (int idx = threadIdx.x; idx < (x.cs - 1) * q; idx += STREAM_CONSUMERS) {
    const int j = idx / q, u = idx - j * q;
    const uint32_t p = (uint32_t)j < rank ? (uint32_t)j : (uint32_t)j + 1;
    const float4 v = reinterpret_cast<const float4*>(src)[u];
    xchg_st_v4(cluster_map(dst0 + 16 * u, p), v, cluster_map(bar, p));
  }
}

// The consumers: wait for every peer's floats of use `use`; thread 0 then
// arms the barrier for use + 2. Returns the buffer [cs, n].
__device__ inline const float* xchg_wait(const Exchange& x, int use) {
  const int b = use & 1;
  const uint32_t bar = x.bar + 8 * b;
  mbar_wait_acquire_cluster(bar, (uint32_t)(use >> 1) & 1u);
  if (threadIdx.x == 0)
    mbar_arrive_expect_tx(bar, (uint32_t)((x.cs - 1) * x.n * 4));
  return x.buf + b * x.stride;
}

// Slot p of an exchange's buffer, or the block's own floats for its rank.
__device__ __forceinline__ const float* xchg_part(const Exchange& x,
                                                  const float* got, int p,
                                                  uint32_t rank, const float* own) {
  return (uint32_t)p == rank ? own : got + p * x.n;
}

// ---------------------------------------------------------------------------
// Host side: the launch plan
// ---------------------------------------------------------------------------

// Cluster size and ring slots used when the caller asks for neither (0):
// measured on an H100 by lets_face_it_tpu_torch/probe_train_kernels.py
// (PERF.md). The cluster is halved until the grid's clusters are all
// resident at once (fit_one_wave).
constexpr int STREAM_DEFAULT_CLUSTER = 2;
constexpr int STREAM_DEFAULT_SLOTS = 3;

struct StreamPlan {
  int bt;              // batch rows per block
  int cs;              // blocks per cluster
  int blocks;          // grid, a multiple of cs
  int nslots;          // ring slots
  int slot_floats;
  int partial_floats;
  int smem_bytes;
  StreamTable table;
};

// A product [IN, NC] of a kernel's schedule.
struct StreamProduct {
  int IN, NC;
};

// Plans a launch for B rows: bt, cs and nslots as asked (0: the defaults:
// the fewest rows per block, up to FLOW_MAX_BT, that need at most one block
// per SM, STREAM_DEFAULT_CLUSTER,
// STREAM_DEFAULT_SLOTS), other_floats(bt) the block's shared floats besides
// the ring and the partial sums. The partial sums get what the widest split
// needs, at most a quarter of what is left; the slots share the rest, up to
// 48 KB each. Returns false if the block does not fit or a chunk piece
// would be empty.
// With `multicast` false (the hidden-split plan) the blocks of a cluster
// share no chunk: cs may reach HSPLIT_MAX_CLUSTER and a chunk is not cut in
// pieces. Every product's width is at most 4 * STREAM_CONSUMERS (one
// column group a consumer thread: stream_matvec writes no other column).
template <typename OtherFloats>
inline bool plan_stream(int B, int bt_req, int cs_req, int slots_req,
                        const FlowDevice& d, const StreamProduct* prods,
                        int n_prods, OtherFloats other_floats,
                        StreamPlan* plan, bool multicast = true) {
  int widest = 0;
  for (int i = 0; i < n_prods; ++i)
    widest = prods[i].NC > widest ? prods[i].NC : widest;
  if (widest > 4 * STREAM_CONSUMERS) return false;
  int bt = bt_req;
  if (bt == 0) {
    bt = 1;
    while (bt < FLOW_MAX_BT && bt * d.sms < B) bt *= 2;
  }
  const int cs = cs_req ? cs_req : STREAM_DEFAULT_CLUSTER;
  const int nslots = slots_req ? slots_req : STREAM_DEFAULT_SLOTS;
  if (cs < 1 || cs > (multicast ? STREAM_MAX_CLUSTER : HSPLIT_MAX_CLUSTER) || bt < 1
      || bt > FLOW_MAX_BT || nslots < 2 || nslots > STREAM_MAX_SLOTS)
    return false;
  if (n_prods > STREAM_MAX_PRODUCTS) return false;
  int need_partial = 0;   // every product at its widest split
  for (int i = 0; i < n_prods; ++i) {
    const int p = stream_slices(prods[i].IN, prods[i].NC, prods[i].IN, bt,
                                1 << 30) * bt * prods[i].NC;
    need_partial = p > need_partial ? p : need_partial;
  }
  const int left = d.max_smem / 4 - STREAM_BAR_FLOATS - round4(other_floats(bt));
  int partial = need_partial < left / 4 ? need_partial : left / 4;
  partial = partial / 4 * 4;
  if (partial < bt * widest) partial = round4(bt * widest);
  int slot = (left - partial) / nslots / 4 * 4;
  if (slot > STREAM_MAX_SLOT_FLOATS) slot = STREAM_MAX_SLOT_FLOATS;
  if (slot < 4 * widest) return false;
  for (int i = 0; i < n_prods; ++i) {
    if (multicast && stream_min_piece_units(slot, prods[i].IN, prods[i].NC) < cs)
      return false;
    plan->table.rpc[i] = stream_chunk_rows(slot, prods[i].NC);
    plan->table.slices[i] = stream_slices(prods[i].IN, prods[i].NC,
                                          plan->table.rpc[i], bt, partial);
    plan->table.inv_groups[i] = 4.0f / prods[i].NC;
  }
  plan->bt = bt;
  plan->cs = cs;
  plan->blocks = ((B + bt - 1) / bt + cs - 1) / cs * cs;
  plan->nslots = nslots;
  plan->slot_floats = slot;
  plan->partial_floats = partial;
  plan->smem_bytes = (STREAM_BAR_FLOATS + nslots * slot
                      + round4(other_floats(bt)) + partial) * (int)sizeof(float);
  return true;
}

// The kernel's shared-memory cap raised to the device's limit and clusters
// above the portable 8 allowed (the hidden split's), once per device
// (`done`: the flags of this kernel instantiation).
template <typename Kernel>
inline cudaError_t allow_stream(Kernel kernel, const FlowDevice& d, bool* done) {
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

// Launches `kernel` as clusters of plan.cs blocks of STREAM_THREADS threads
// on `stream` (allow_stream first).
template <typename Kernel, typename... Args>
inline cudaError_t launch_stream(Kernel kernel, const StreamPlan& plan,
                                 const FlowDevice& d, bool* smem_allowed,
                                 cudaStream_t stream, Args... args) {
  cudaError_t err = allow_stream(kernel, d, smem_allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks);
  cfg.blockDim = dim3(STREAM_THREADS);
  cfg.dynamicSmemBytes = plan.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Clusters of the plan that the device holds at once (0 if it cannot hold
// one), by cudaOccupancyMaxActiveClusters.
template <typename Kernel>
inline int stream_max_clusters(Kernel kernel, const StreamPlan& plan,
                               const FlowDevice& d, bool* smem_allowed) {
  if (allow_stream(kernel, d, smem_allowed) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.blocks);
  cfg.blockDim = dim3(STREAM_THREADS);
  cfg.dynamicSmemBytes = plan.smem_bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// Halves plan->cs (replan(cs) plans again) until the device holds all of
// the grid's clusters at once: a cluster lives on one GPC, and a second wave
// of clusters would wait for the first to finish the whole sequence.
template <typename Kernel, typename Replan>
inline cudaError_t fit_one_wave(Kernel kernel, const FlowDevice& d,
                                bool* smem_allowed, StreamPlan* plan,
                                Replan replan) {
  while (plan->cs > 1) {
    const int n = stream_max_clusters(kernel, *plan, d, smem_allowed);
    if (n < 0) return cudaErrorInvalidValue;
    if (plan->blocks / plan->cs <= n) break;
    if (!replan(plan->cs / 2, plan)) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// The gates of the sampling chain that do not depend on it, for Hopper
// (sm_90a): for one frame and all K flow steps at once,
//   proj[k] = fixed[k] + hist @ w_p1_t[k]                 (own face, P1 > 0)
//   gh[k]   = h[k] @ w_hh_t[k] + b_hh[k]                  (the previous frame's state)
//   gc[k]   = leaky_relu(proj[k]) @ w_ih_t[k][Z1:] + b_ih[k]
// gc needs the whole of proj[k], so a frame takes two launches when P1 > 0
// (proj with gh, then gc) and one otherwise (gh with gc).
//
// Every product is out[k, b, :] = act(X[k, b, :]) @ W[k] (+ bias[k])
// (+ addend[k, b, :]) over B batch rows, and the launcher takes one of two
// plans by B (gates_enqueue; ops/flow_kernels.py::gates_plan mirrors it):
//
// "vector", few rows (below GATES_TILE_FROM_ROWS_F32 = 64 at "highest",
// GATES_TILE_FROM_ROWS = 16 at the reduced modes): matrix-vector products.
// At B = 1 the launch reads 24.9 MB of weights (final_model) for 0.8
// MFLOP: it is bound by the bytes it moves from L2. The grid splits K x
// column tiles (x row tiles) over many blocks, so that every SM reads
// weights at once and each weight element is read once per launch and row
// tile. A block stages its rows of X in shared memory; each of its 256
// threads owns four neighbouring columns (one 16-byte load per weight row)
// of an interleaved slice of the input rows, four rows at a time, and keeps
// the BT rows' sums in registers; the slices meet by warp shuffles and a
// shared-memory sum. Few rows take narrow tiles (GR = 8 column groups, 32
// columns, 32 slices: many blocks for few bytes each); more take wide
// ones (GR = 32, 128 columns, 8 slices). At a reduced matmul precision
// (GateLaunch::mode) the staged rows of X are rounded once and each weight
// as it is loaded (flow_step.cuh::round_operand), so the weights may come
// rounded (the prepared set) or not (the own-face slice w_p1_t, which the
// caller hands as it is).
//
// "tile", many rows: at B = 128 the vector plan caps its rows a block at 8,
// so it reads every weight 16 times a launch and ran at 4x its bound, behind
// cuBLAS. This plan is gates_mma.cuh's tile product: a block holds 64 rows
// of X and a column tile of W 64 (or 32) columns wide, so that the gc
// launch at B = 128 still spreads over 192 blocks of the 132 SMs, with no
// split of the depth and its atomics; four warps, three stages deep. It
// multiplies on the tensor cores: TF32 or bf16 operands rounded as their
// fragments are read (the own-face slice's weights too, which the caller
// hands unrounded), a 3xTF32 split at "highest". The tile and the
// thresholds are probe_sampling_kernels.py --gates's measurements
// (PERF.md): a ring six deep (tile 1) and 64 x 32 tiles (tile 2) read no
// faster.
//
// Included by the launchers (frame_rev.cu, seq_rev.cu, sample_gates.cu).

#pragma once

#include <cuda_runtime.h>

#include "flow_step.cuh"
#include "gates_mma.cuh"

// Internal linkage: each launcher library (frame_rev, seq_rev, sample_*)
// keeps its own kernels and its own once-per-device flags; the static
// locals of inline functions would otherwise be one object shared by
// every library loaded into the process.
namespace {

constexpr int GATES_THREADS = 256;
constexpr int GATES_WARPS = GATES_THREADS / 32;
// Rows per block the launcher picks at most (more re-read fewer weights but
// hold more sums a thread: 8 measured best, PERF.md).
constexpr int GATES_DEFAULT_MAX_BT = 8;
// Rows per block from which the wide tile is the default.
constexpr int GATES_WIDE_FROM_BT = 8;
constexpr int GATES_MAX_PRODUCTS = 2;
// Rows from which the launcher takes the many-row plan: at "highest" its
// 3xTF32 split makes three products of each, so it wins from 64 rows; at
// "high" and "medium" from 16 (probe_sampling_kernels.py --gates, PERF.md).
constexpr int GATES_TILE_FROM_ROWS_F32 = 64, GATES_TILE_FROM_ROWS = 16;
// The plans (`plan` of gates_enqueue): the launcher's by rows, the vector
// plan, or the tile plan with tile GATES_PLAN_TILE + i of gates_tile_launch.
constexpr int GATES_PLAN_AUTO = 0, GATES_PLAN_VECTOR = 1, GATES_PLAN_TILE = 2;
constexpr int GATES_TILES = 3;          // gates_tile_launch's
constexpr int GATES_TILE_DEFAULT = 0;

// out[k*out_k + b*NC + c] = act(X[k*x_k + b*ldx + i]) * W[k*w_k + i*NC + c]
// summed over i < IN, plus bias[k*NC + c] and addend[k*add_k + b*NC + c]
// (either may be null), for k < K, b < B, c < NC. IN % 4 == 0, NC % 4 == 0,
// X, W, addend and out 16-byte aligned.
struct GateProduct {
  const float* X;
  long long x_k;
  int ldx;
  const float* W;
  long long w_k;
  int IN, NC;
  const float* bias;
  const float* addend;
  long long add_k;
  float* out;
  long long out_k;
  int leaky;
  int w_rounded;   // W already rounded for the launch's mode (the prepared set)
  int col_tiles;   // ceil(NC / (4 * GR))
};

struct GateLaunch {
  GateProduct p[GATES_MAX_PRODUCTS];
  int n;
  int K, B;
  int blocks0;     // blocks of product 0 (K * its col_tiles)
  int max_in;      // the widest IN, for the X tile in shared memory
  int mode;        // FlowPrecision of the products
};

__host__ __device__ inline int gates_smem_floats(int bt, int gr, int max_in) {
  return bt * max_in + GATES_WARPS * bt * 4 * gr;
}

// GR: column groups of four a block (the tile is 4 * GR columns wide).
template <int BT, int GR>
__global__ void __launch_bounds__(GATES_THREADS)
sample_gates_kernel(GateLaunch L) {
  constexpr int TILE = 4 * GR, SLICES = GATES_THREADS / GR;
  extern __shared__ __align__(16) float gsm[];
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  const bool second = blk >= L.blocks0;
  if (second) blk -= L.blocks0;
  const GateProduct& P = second ? L.p[1] : L.p[0];
  const int k = blk / P.col_tiles;
  const int c0 = (blk - k * P.col_tiles) * TILE;
  const int row0 = blockIdx.y * BT;
  const int rows = min(BT, L.B - row0);
  const int IN = P.IN, NC = P.NC;

  // X rows of this tile, activation applied, zeros past the batch
  float* xs = gsm;                                        // [BT, IN]
  float* red = xs + BT * P.IN;                            // [warps, BT, TILE]
  const float* xk = P.X + (size_t)k * P.x_k + (size_t)row0 * P.ldx;
  for (int idx = tid; idx < BT * IN / 4; idx += GATES_THREADS) {
    const int r = idx / (IN / 4), q = idx - r * (IN / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = *reinterpret_cast<const float4*>(xk + (size_t)r * P.ldx + 4 * q);
    if (P.leaky)
      v = make_float4(leaky_relu_(v.x), leaky_relu_(v.y), leaky_relu_(v.z),
                      leaky_relu_(v.w));
    *reinterpret_cast<float4*>(xs + r * IN + 4 * q) = round_operand(v, L.mode);
  }
  __syncthreads();

  const int cg = tid % GR, sl = tid / GR;
  const int col = c0 + 4 * cg;
  const bool active = col < NC;   // NC % 4 == 0: a float4 is wholly in or out
  float4 acc[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    const float* wk = P.W + (size_t)k * P.w_k + col;
    const int quads = IN / 4;
#pragma unroll 2
    for (int q = sl; q < quads; q += SLICES) {
      const float* wq = wk + (size_t)(4 * q) * NC;
      float4 w0 = __ldg(reinterpret_cast<const float4*>(wq));
      float4 w1 = __ldg(reinterpret_cast<const float4*>(wq + NC));
      float4 w2 = __ldg(reinterpret_cast<const float4*>(wq + 2 * NC));
      float4 w3 = __ldg(reinterpret_cast<const float4*>(wq + 3 * NC));
      if (L.mode != FLOW_F32) {
        w0 = round_operand(w0, L.mode);
        w1 = round_operand(w1, L.mode);
        w2 = round_operand(w2, L.mode);
        w3 = round_operand(w3, L.mode);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(xs + r * IN + 4 * q);
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
  // the slices of a warp (lanes GR apart) by shuffles, then the warps
#pragma unroll
  for (int r = 0; r < BT; ++r) {
#pragma unroll
    for (int off = GR; off < 32; off *= 2) {
      acc[r].x += __shfl_xor_sync(0xffffffffu, acc[r].x, off);
      acc[r].y += __shfl_xor_sync(0xffffffffu, acc[r].y, off);
      acc[r].z += __shfl_xor_sync(0xffffffffu, acc[r].z, off);
      acc[r].w += __shfl_xor_sync(0xffffffffu, acc[r].w, off);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < GR) {
#pragma unroll
    for (int r = 0; r < BT; ++r)
      *reinterpret_cast<float4*>(red + (warp * BT + r) * TILE + 4 * lane) = acc[r];
  }
  __syncthreads();
  for (int idx = tid; idx < BT * TILE; idx += GATES_THREADS) {
    const int r = idx / TILE, c = idx - r * TILE;
    if (r >= rows || c0 + c >= NC) continue;
    float v = 0.0f;
#pragma unroll
    for (int wp = 0; wp < GATES_WARPS; ++wp) v += red[(wp * BT + r) * TILE + c];
    if (P.bias) v += P.bias[(size_t)k * NC + c0 + c];
    const size_t o = (size_t)(row0 + r) * NC + c0 + c;
    if (P.addend) v += P.addend[(size_t)k * P.add_k + o];
    P.out[(size_t)k * P.out_k + o] = v;
  }
  // A chain launched after this kernel may start its set-up once every block
  // has come this far (no block of this grid then waits for an SM); it reads
  // these results only after the whole grid has finished.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <int BT, int GR>
inline cudaError_t gates_launch_bt(const GateLaunch& L, dim3 grid, int smem,
                                   const FlowDevice& d, cudaStream_t stream) {
  static bool allowed[FLOW_MAX_DEVICES] = {};
  cudaError_t err = allow_max_smem(sample_gates_kernel<BT, GR>, d, allowed);
  if (err != cudaSuccess) return err;
  sample_gates_kernel<BT, GR><<<grid, GATES_THREADS, smem, stream>>>(L);
  return cudaGetLastError();
}

template <int GR>
inline cudaError_t gates_launch_gr(int bt, const GateLaunch& L, dim3 grid,
                                   int smem, const FlowDevice& d,
                                   cudaStream_t stream) {
  switch (bt) {
    case 1: return gates_launch_bt<1, GR>(L, grid, smem, d, stream);
    case 2: return gates_launch_bt<2, GR>(L, grid, smem, d, stream);
    case 4: return gates_launch_bt<4, GR>(L, grid, smem, d, stream);
    case 8: return gates_launch_bt<8, GR>(L, grid, smem, d, stream);
    case 16: return gates_launch_bt<16, GR>(L, grid, smem, d, stream);
    default: return (cudaError_t)FLOW_ERR_PLAN;
  }
}

// Rows per block: the least power of two that covers B, at most
// GATES_DEFAULT_MAX_BT, halved while the block's shared memory does not fit (0 if
// one row does not fit). bt_req > 0 asks for that tile.
inline int gates_pick_bt(int B, int gr, int max_in, int bt_req, const FlowDevice& d) {
  int bt = bt_req;
  if (bt == 0) {
    bt = 1;
    while (bt < GATES_DEFAULT_MAX_BT && bt < B) bt *= 2;
  }
  while (bt > 0 && gates_smem_floats(bt, gr, max_in) * 4 > d.max_smem) bt /= 2;
  return bt;
}

inline GateProduct gate_product(const float* X, long long x_k, int ldx,
                                const float* W, long long w_k, int IN, int NC,
                                const float* bias, const float* addend,
                                long long add_k, float* out, long long out_k,
                                bool leaky, bool w_rounded) {
  GateProduct p{X, x_k, ldx, W, w_k, IN, NC, bias, addend, add_k, out, out_k,
                leaky ? 1 : 0, w_rounded ? 1 : 0, 0};
  return p;
}

// The many-row plan: one gates_mma.cuh launch of the products, tile `tile`
// (0 .. GATES_TILES - 1: BM x BN, warp tiles, stages; ops/flow_kernels.py::
// GATES_TILES mirrors them).
inline cudaError_t gates_tile_launch(const GateProduct* prods, int n, int K,
                                     int B, int tile, int mode,
                                     const FlowDevice& d, cudaStream_t stream) {
  MmaLaunch L = {};
  L.n = n;
  L.M = B;
  L.inner = B;
  bool round_w = false;
  for (int i = 0; i < n; ++i) {
    const GateProduct& g = prods[i];
    MmaProduct& p = L.p[i];
    p.X = g.X;
    p.x_k = g.x_k;
    p.ldx = g.ldx;
    p.W = g.W;
    p.w_k = g.w_k;
    p.IN = g.IN;
    p.NC = g.NC;
    p.bias = g.bias;
    p.addend = g.addend;
    p.add_k = g.add_k;
    p.out = g.out;
    p.out_k = g.out_k;
    p.leaky = g.leaky;
    round_w = round_w || !g.w_rounded;
  }
  switch (tile) {
    case 0: return mma_enqueue<64, 64, 32, 32, 3>(L, K, mode, round_w, d, stream);
    case 1: return mma_enqueue<64, 64, 32, 32, 6>(L, K, mode, round_w, d, stream);
    case 2: return mma_enqueue<64, 32, 32, 16, 6>(L, K, mode, round_w, d, stream);
    default: return (cudaError_t)FLOW_ERR_PLAN;
  }
}

// The launcher's plan for B rows at matmul precision `mode`: the tile plan
// from GATES_TILE_FROM_ROWS(_F32) rows on, unless a vector tile (bt_req,
// gr_req) is asked for.
inline int gates_plan(int B, int bt_req, int gr_req, int mode) {
  const int from = mode == FLOW_F32 ? GATES_TILE_FROM_ROWS_F32 : GATES_TILE_FROM_ROWS;
  if (bt_req != 0 || gr_req != 0 || B < from) return GATES_PLAN_VECTOR;
  return GATES_PLAN_TILE + GATES_TILE_DEFAULT;
}

// One launch of up to two products over K steps and B rows at matmul
// precision `mode`, added to *launches (and to *tile_launches on the tile
// plan); `plan` GATES_PLAN_AUTO for gates_plan's; bt_req and gr_req (8 or
// 32 column groups a block) 0 for the vector plan's defaults.
inline cudaError_t gates_enqueue(const GateProduct* prods, int n, int K, int B,
                                 int bt_req, int gr_req, int plan, int mode,
                                 const FlowDevice& d, cudaStream_t stream,
                                 int* launches, int* tile_launches) {
  if ((gr_req != 0 && gr_req != 8 && gr_req != 32) || !precision_valid(mode)
      || plan < GATES_PLAN_AUTO || plan >= GATES_PLAN_TILE + GATES_TILES)
    return (cudaError_t)FLOW_ERR_ARGS;
  int max_in = 0;
  for (int i = 0; i < n; ++i) {
    const GateProduct& p = prods[i];
    if (p.IN % 4 != 0 || p.NC % 4 != 0 || p.IN < 4)
      return (cudaError_t)FLOW_ERR_ARGS;
    max_in = p.IN > max_in ? p.IN : max_in;
  }
  if (plan == GATES_PLAN_AUTO) plan = gates_plan(B, bt_req, gr_req, mode);
  if (plan >= GATES_PLAN_TILE) {
    const cudaError_t err = gates_tile_launch(prods, n, K, B, plan - GATES_PLAN_TILE,
                                              mode, d, stream);
    if (err == cudaSuccess) {
      ++*launches;
      ++*tile_launches;
    }
    return err;
  }
  int bt = gates_pick_bt(B, gr_req ? gr_req : 32, max_in, bt_req, d);
  const int gr = gr_req ? gr_req : bt >= GATES_WIDE_FROM_BT ? 32 : 8;
  bt = gates_pick_bt(B, gr, max_in, bt, d);
  if (bt == 0) return (cudaError_t)FLOW_ERR_PLAN;
  GateLaunch L = {};
  L.n = n;
  L.K = K;
  L.B = B;
  L.max_in = max_in;
  L.mode = mode;
  int blocks = 0;
  for (int i = 0; i < n; ++i) {
    L.p[i] = prods[i];
    L.p[i].col_tiles = (prods[i].NC + 4 * gr - 1) / (4 * gr);
    if (i == 0) L.blocks0 = K * L.p[i].col_tiles;
    blocks += K * L.p[i].col_tiles;
  }
  const dim3 grid(blocks, (B + bt - 1) / bt);
  const int smem = gates_smem_floats(bt, gr, max_in) * (int)sizeof(float);
  const cudaError_t err = gr == 32 ? gates_launch_gr<32>(bt, L, grid, smem, d, stream)
                                   : gates_launch_gr<8>(bt, L, grid, smem, d, stream);
  if (err == cudaSuccess) ++*launches;
  return err;
}

// The gates of one frame. fixed [K, B, COND] (the frame's slice of
// fixed_projs, or the given cond_projs when P1 == 0), hist [B, P1],
// w_p1_t [K, P1, COND], states [K, B, H]; writes proj [K, B, COND] (P1 > 0
// only), gc and gh [K, B, 3H], at matmul precision `mode`, on plan `plan`
// (gates_enqueue's). Two launches when P1 > 0, else one; each is added to
// *launches, and those of the tile plan to *tile_launches too.
inline cudaError_t sample_gates_enqueue(
    const float* fixed, const float* hist, const float* w_p1_t,
    const float* states, const float* w_ih_t, const float* w_hh_t,
    const float* b_ih, const float* b_hh, float* proj, float* gc, float* gh,
    int B, int P1, int K, int Z1, int COND, int H, int bt_req, int gr_req,
    int plan, int mode, const FlowDevice& d, cudaStream_t stream,
    int* launches, int* tile_launches) {
  const int G = 3 * H, IN = Z1 + COND;
  const GateProduct p_gh = gate_product(states, (long long)B * H, H, w_hh_t,
                                        (long long)H * G, H, G, b_hh, nullptr,
                                        0, gh, (long long)B * G, false, true);
  const float* cond = fixed;
  cudaError_t err;
  if (P1 > 0) {
    const GateProduct first[2] = {
        gate_product(hist, 0, P1, w_p1_t, (long long)P1 * COND, P1, COND,
                     nullptr, fixed, (long long)B * COND, proj,
                     (long long)B * COND, false, false),
        p_gh};
    err = gates_enqueue(first, 2, K, B, bt_req, gr_req, plan, mode, d, stream,
                        launches, tile_launches);
    if (err != cudaSuccess) return err;
    cond = proj;
  }
  const GateProduct p_gc = gate_product(cond, (long long)B * COND, COND,
                                        w_ih_t + (size_t)Z1 * G,
                                        (long long)IN * G, COND, G, b_ih,
                                        nullptr, 0, gc, (long long)B * G, true,
                                        true);
  if (P1 > 0)
    return gates_enqueue(&p_gc, 1, K, B, bt_req, gr_req, plan, mode, d, stream,
                         launches, tile_launches);
  const GateProduct both[2] = {p_gc, p_gh};
  return gates_enqueue(both, 2, K, B, bt_req, gr_req, plan, mode, d, stream,
                       launches, tile_launches);
}

}  // namespace

// The conditioning gates of the training forward, for Hopper (sm_90a):
//   gc[t, k, b, :] = leaky_relu(cond[t, k, b, :]) @ w_ih_t[k][Z1:] + b_ih[k]
// for every frame t, flow step k and batch row b, as one launch.
//
// Replaces: the conditioning half of the GRU input product in
// lets_face_it_tpu/ops/pallas_train.py::_fwd_kernel (the `gi` dot), which is
// 512 of the 540 input rows for final_model. It does not depend on the
// kernel's serial chain, so it is taken out of it: seq_fwd.cu adds gc to the
// Z1 rows of the product, and seq_bwd.cu reads gc in its recompute.
//
// What bounds it on an H100: per step k a product of [N * B, COND] @
// [COND, 3H]; for final_model at B = 256, N = 56 that is 14,336 rows x 512
// x 384 x 16 steps = 90.2 GFLOP, and it reads 470 MB of cond and writes
// 352 MB of gc (0.25 ms at 3.35 TB/s). On the tensor cores (0.18 ms at
// TF32's 495 TFLOP/s, 0.09 at bf16's 989) the bytes bound it; on the CUDA
// cores (1.35 ms at the 67 TFLOP/s of float32 FMA) the operations.
//
// Two plans, each with its tiles, chosen by the launcher (cond_gates_plan;
// `plan` and `tile` force one; probe_train_kernels.py --gates times them):
//   "tc", at "high" and "medium": the tile product of gates_mma.cuh, by
//   default 128 x 128 tiles of 8 warps, each a 32 x 64 warp tile of
//   mma.sync, three stages deep (two blocks an SM; wider warp tiles, a
//   fourth stage and 256-row tiles of one block an SM read slower), on TF32 or bf16
//   operands rounded as their fragments are read (the wrapper hands the
//   weights rounded, so only the activations round). It replaces the SIMT
//   plan at those modes, which rounded operands on the CUDA cores at a
//   tenth of the bound and lost to cuBLAS's tensor cores 3x. Its 3xTF32
//   tiles at "highest" are closer to the float64 product than float32 is,
//   but not the launcher's: see cond_gates_plan.
//   "simt", at "highest": a register-tiled SIMT GEMM in float32, batched
//   over k by blockIdx.z. A block of 256 threads computes a 128 x 128 tile
//   of gc; each thread an 8 x 8 sub-tile (two 4-row by two 4-column
//   quarters, so that its shared-memory reads are 16-byte and the warp's are
//   free of bank conflicts). Tile 0 (the plan before the redesign) stages
//   operand tiles of depth 8 in two buffers: the weight tile by cp.async
//   (zero-filled past the edge), the cond tile through registers, where
//   leaky_relu is applied and the tile is transposed as it is stored. The
//   other tiles (cond_gates_ring_kernel) stage both by cp.async in a ring of
//   3 or 4 tiles 16 deep (4, the launcher's), cond row-major, leaky_relu
//   applied in place by the thread that copied each chunk, so a barrier and
//   the cond tile's round trip through registers come once a 16 depths, not
//   once an 8 (2.51 -> 2.16 ms at B = 256, N = 56 on an H100, PERF.md). Both
//   accumulate each output as one FMA chain in the depth's order, as
//   cuBLAS's float32 GEMM does: the plain version's bits.
//   At a reduced matmul precision (forced) the activation is rounded with
//   leaky_relu; the wrapper hands the weights rounded.
// The rows of one k are strided in cond and gc ([N, K, B, *]); the kernels
// map row m = t * B + b themselves. This file allocates nothing and launches
// on the caller's stream.

#include <cstdint>

#include <cuda_runtime.h>

#include "flow_step.cuh"
#include "gates_mma.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int THREADS = 256;
constexpr int APAD = 4;   // As rows of BM + 4 floats: conflict-free stores

__device__ __forceinline__ float leaky(float x) { return x >= 0.0f ? x : 0.01f * x; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
cond_gates_kernel(const float* __restrict__ cond,   // [N, K, B, COND]
                  const float* __restrict__ w_ih_t, // [K, Z1 + COND, G]
                  const float* __restrict__ b_ih,   // [K, G]
                  float* __restrict__ gc,           // [N, K, B, G]
                  int B, int N, int K, int Z1, int COND, int G, int mode) {
  __shared__ __align__(16) float As[2][BK][BM + APAD];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k = blockIdx.z;
  const int M = N * B;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* W = w_ih_t + ((size_t)k * (Z1 + COND) + Z1) * G;

  // A: thread loads row am, depths ak..ak+3 of the tile
  const int am = tid / 2, ak = (tid % 2) * 4;
  const int mg = m0 + am;
  const bool a_row = mg < M;
  const float* a_src = cond;
  if (a_row) {
    const int t = mg / B, b = mg - t * B;
    a_src = cond + (((size_t)t * K + k) * B + b) * COND;
  }
  // B: thread loads depth bk, columns bn..bn+3 of the tile
  const int bk = tid / 32, bn = (tid % 32) * 4;
  const bool b_col = n0 + bn < G;

  auto load_a = [&](int k0) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a_row && k0 + ak < COND)
      v = *reinterpret_cast<const float4*>(a_src + k0 + ak);
    return round_operand(make_float4(leaky(v.x), leaky(v.y), leaky(v.z),
                                     leaky(v.w)), mode);
  };
  auto store_a = [&](int buf, float4 v) {
    As[buf][ak + 0][am] = v.x;
    As[buf][ak + 1][am] = v.y;
    As[buf][ak + 2][am] = v.z;
    As[buf][ak + 3][am] = v.w;
  };
  auto load_b = [&](int buf, int k0) {
    const bool valid = b_col && k0 + bk < COND;
    cp_async16(&Bs[buf][bk][bn],
               valid ? W + (size_t)(k0 + bk) * G + n0 + bn : W, valid);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_b(0, 0);
  store_a(0, load_a(0));
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  const int tiles = (COND + BK - 1) / BK;
  for (int kt = 0; kt < tiles; ++kt) {
    const int buf = kt & 1;
    const bool next = kt + 1 < tiles;
    float4 a_next;
    if (next) {
      load_b(buf ^ 1, (kt + 1) * BK);
      a_next = load_a((kt + 1) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (next) {
      store_a(buf ^ 1, a_next);
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
  }

  // epilogue: bias, and the rows mapped back to [N, K, B, G]
  const float* bias = b_ih + (size_t)k * G;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    const int t = m / B, b = m - t * B;
    float* out = gc + (((size_t)t * K + k) * B + b) * G;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= G) continue;   // G % 4 == 0: the float4 is wholly in or out
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      *reinterpret_cast<float4*>(out + n) =
          make_float4(acc[i][4 * h + 0] + bv.x, acc[i][4 * h + 1] + bv.y,
                      acc[i][4 * h + 2] + bv.z, acc[i][4 * h + 3] + bv.w);
    }
  }
}

// The SIMT GEMM with both operands staged by cp.async in a ring of STAGES
// tiles of depth SBK, cond row-major: each thread applies leaky_relu (and the
// mode's rounding) in place to the chunks it copied, once a block, and
// reads four depths of a row as one float4. Every output is still one FMA
// chain over the depth in ascending order, as in cond_gates_kernel, so the
// two plans give the same bits.
template <int SBK, int STAGES, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
cond_gates_ring_kernel(const float* __restrict__ cond,   // [N, K, B, COND]
                       const float* __restrict__ w_ih_t, // [K, Z1 + COND, G]
                       const float* __restrict__ b_ih,   // [K, G]
                       float* __restrict__ gc,           // [N, K, B, G]
                       int B, int N, int K, int Z1, int COND, int G) {
  constexpr int SA = SBK + 4;          // the two rows a warp reads: other banks
  constexpr int STAGE = BM * SA + SBK * BN;
  constexpr int AQ = SBK / 4;          // 16-byte chunks a row
  constexpr int A_CH = BM * AQ / THREADS, B_CH = SBK * (BN / 4) / THREADS;
  static_assert(A_CH * THREADS == BM * AQ && B_CH * THREADS == SBK * (BN / 4), "");
  extern __shared__ __align__(16) float rsm[];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k = blockIdx.z;
  const int M = N * B;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const float* W = w_ih_t + ((size_t)k * (Z1 + COND) + Z1) * G;

  const int aq = tid % AQ;
  const float* a_row[A_CH];
#pragma unroll
  for (int i = 0; i < A_CH; ++i) {
    const int m = m0 + tid / AQ + i * (THREADS / AQ);
    a_row[i] = nullptr;
    if (m < M) {
      const int t = m / B, b = m - t * B;
      a_row[i] = cond + (((size_t)t * K + k) * B + b) * COND;
    }
  }
  auto load = [&](int s, int kt) {
    const int k0 = kt * SBK;
    float* As = rsm + s * STAGE;
    float* Bs = As + BM * SA;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int r = tid / AQ + i * (THREADS / AQ);
      const bool ok = a_row[i] != nullptr && k0 + 4 * aq < COND;
      cp_async16(As + r * SA + 4 * aq, ok ? a_row[i] + k0 + 4 * aq : cond, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int c = tid + i * THREADS;
      const int kk = c / (BN / 4), q = c % (BN / 4);
      const bool ok = k0 + kk < COND && n0 + 4 * q < G;
      cp_async16(Bs + kk * BN + 4 * q, ok ? W + (size_t)(k0 + kk) * G + n0 + 4 * q : W, ok);
    }
  };
  // the A chunks this thread copied (complete after its wait_group)
  auto activate = [&](int s) {
    float* As = rsm + s * STAGE;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      float4* p = reinterpret_cast<float4*>(As + (tid / AQ + i * (THREADS / AQ)) * SA + 4 * aq);
      const float4 v = *p;   // leaky_relu as max(x, 0.01 x): the same bits
      *p = round_operand<MODE>(make_float4(fmaxf(v.x, 0.01f * v.x), fmaxf(v.y, 0.01f * v.y),
                                           fmaxf(v.z, 0.01f * v.z), fmaxf(v.w, 0.01f * v.w)));
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int tiles = (COND + SBK - 1) / SBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s, s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int kt = 0; kt < tiles; ++kt) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    activate(kt % STAGES);
    __syncthreads();   // tile kt visible; tile kt - 1's slot free
    const int pre = kt + STAGES - 1;
    if (pre < tiles) load(pre % STAGES, pre);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const float* As = rsm + (kt % STAGES) * STAGE;
    const float* Bs = As + BM * SA;
#pragma unroll
    for (int kk = 0; kk < SBK; kk += 4) {
      float4 b[4][2];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        b[d][0] = *reinterpret_cast<const float4*>(&Bs[(kk + d) * BN + tx * 4]);
        b[d][1] = *reinterpret_cast<const float4*>(&Bs[(kk + d) * BN + 64 + tx * 4]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
        const float4 a4 = *reinterpret_cast<const float4*>(&As[r * SA + kk]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const float bv[8] = {b[d][0].x, b[d][0].y, b[d][0].z, b[d][0].w,
                               b[d][1].x, b[d][1].y, b[d][1].z, b[d][1].w};
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[d], bv[j], acc[i][j]);
        }
      }
    }
  }

  const float* bias = b_ih + (size_t)k * G;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
    const int t = m / B, b = m - t * B;
    float* out = gc + (((size_t)t * K + k) * B + b) * G;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= G) continue;
      const float4 bv = *reinterpret_cast<const float4*>(bias + n);
      *reinterpret_cast<float4*>(out + n) =
          make_float4(acc[i][4 * h + 0] + bv.x, acc[i][4 * h + 1] + bv.y,
                      acc[i][4 * h + 2] + bv.z, acc[i][4 * h + 3] + bv.w);
    }
  }
}

template <int SBK, int STAGES, int MODE>
inline cudaError_t cond_gates_ring_mode(const float* cond, const float* w_ih_t,
                                        const float* b_ih, float* gc, int B, int N,
                                        int K, int Z1, int COND, int G,
                                        const FlowDevice& d, cudaStream_t st) {
  constexpr int SMEM = STAGES * (BM * (SBK + 4) + SBK * BN) * (int)sizeof(float);
  static bool allowed[FLOW_MAX_DEVICES] = {};
  auto kernel = cond_gates_ring_kernel<SBK, STAGES, MODE>;
  cudaError_t err = allow_max_smem(kernel, d, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((N * B + BM - 1) / BM, (G + BN - 1) / BN, K);
  kernel<<<grid, THREADS, SMEM, st>>>(cond, w_ih_t, b_ih, gc, B, N, K, Z1, COND, G);
  return cudaGetLastError();
}

template <int SBK, int STAGES>
inline cudaError_t cond_gates_ring(const float* cond, const float* w_ih_t,
                                   const float* b_ih, float* gc, int B, int N,
                                   int K, int Z1, int COND, int G, int mode,
                                   const FlowDevice& d, cudaStream_t st) {
  switch (mode) {
    case FLOW_F32:
      return cond_gates_ring_mode<SBK, STAGES, FLOW_F32>(cond, w_ih_t, b_ih, gc, B, N, K,
                                                         Z1, COND, G, d, st);
    case FLOW_TF32:
      return cond_gates_ring_mode<SBK, STAGES, FLOW_TF32>(cond, w_ih_t, b_ih, gc, B, N, K,
                                                          Z1, COND, G, d, st);
    case FLOW_BF16:
      return cond_gates_ring_mode<SBK, STAGES, FLOW_BF16>(cond, w_ih_t, b_ih, gc, B, N, K,
                                                          Z1, COND, G, d, st);
    default: return (cudaError_t)FLOW_ERR_ARGS;
  }
}

}  // namespace

// The plans (`plan`, and what *plan_out receives) and their tiles (`tile`):
// the SIMT GEMM, tile i of cond_gates_simt, or the tensor
// cores, tile i of cond_gates_tc (probe_train_kernels.py --gates times them
// all; ops/train_kernels.py::COND_GATES_TILES mirrors both lists).
constexpr int COND_PLAN_AUTO = 0, COND_PLAN_SIMT = 1, COND_PLAN_TC = 2;
constexpr int COND_SIMT_TILES = 3, COND_TC_TILES = 4;

// The launcher's plan and tile at matmul precision `mode`
// (ops/train_kernels.py::cond_gates_plan mirrors it): at "highest" the SIMT
// GEMM, whose float32 FMA chains give the plain version's bits (the 3xTF32
// tiles are closer to the float64 product, but the serial chain spreads
// their other rounding past the training forward's 1e-5 at C = 54); at
// "high" and "medium" the tensor cores.
inline void cond_gates_plan(int mode, int* plan, int* tile) {
  if (mode == FLOW_F32) {
    *plan = COND_PLAN_SIMT;
    *tile = 2;
  } else {
    *plan = COND_PLAN_TC;
    *tile = 0;
  }
}

inline cudaError_t cond_gates_simt(const float* cond, const float* w_ih_t,
                                   const float* b_ih, float* gc, int B, int N,
                                   int K, int Z1, int COND, int G, int mode,
                                   int tile, const FlowDevice& d, cudaStream_t st) {
  switch (tile) {
    case 0: {
      const dim3 grid((N * B + BM - 1) / BM, (G + BN - 1) / BN, K);
      cond_gates_kernel<<<grid, THREADS, 0, st>>>(cond, w_ih_t, b_ih, gc, B, N, K,
                                                  Z1, COND, G, mode);
      return cudaGetLastError();
    }
    case 1: return cond_gates_ring<16, 3>(cond, w_ih_t, b_ih, gc, B, N, K, Z1, COND, G, mode, d, st);
    case 2: return cond_gates_ring<16, 4>(cond, w_ih_t, b_ih, gc, B, N, K, Z1, COND, G, mode, d, st);
    default: return (cudaError_t)FLOW_ERR_PLAN;
  }
}

// Tensor-core tile i: BM x BN, warp tiles WM x WN, STAGES deep.
inline cudaError_t cond_gates_tc(const MmaLaunch& L, int K, int mode, int tile,
                                 const FlowDevice& d, cudaStream_t st) {
  switch (tile) {
    case 0: return mma_enqueue<128, 128, 32, 64, 3>(L, K, mode, false, d, st);
    case 1: return mma_enqueue<128, 128, 64, 32, 3>(L, K, mode, false, d, st);
    case 2: return mma_enqueue<128, 128, 32, 64, 4>(L, K, mode, false, d, st);
    case 3: return mma_enqueue<256, 128, 64, 64, 3>(L, K, mode, false, d, st);
    default: return (cudaError_t)FLOW_ERR_PLAN;
  }
}

// gc [N, K, B, 3H] from cond [N, K, B, COND], the weights w_ih_t
// [K, Z1 + COND, 3H] (rounded for `mode` by the caller) and b_ih [K, 3H];
// `plan` COND_PLAN_AUTO for the launcher's plan and tile, else
// COND_PLAN_SIMT or COND_PLAN_TC with `tile` (-1: the plan's first). The
// plan launched is written to *plan_out.
extern "C" int cond_gates_launch(const float* cond, const float* w_ih_t,
                                 const float* b_ih, float* gc, int B, int N,
                                 int K, int Z1, int COND, int H, int mode,
                                 int plan, int tile, void* stream, int* plan_out) {
  const int G = 3 * H;
  if (B < 1 || N < 1 || K < 1 || COND % 4 != 0 || G % 4 != 0 || Z1 < 0
      || !precision_valid(mode) || plan < COND_PLAN_AUTO || plan > COND_PLAN_TC
      || tile < -1 || tile >= (plan == COND_PLAN_SIMT ? COND_SIMT_TILES : COND_TC_TILES)
      || (long long)N * B >= (1LL << 31) / BM)
    return (int)cudaErrorInvalidValue;
  if (plan == COND_PLAN_AUTO) cond_gates_plan(mode, &plan, &tile);
  if (tile < 0) tile = 0;
  cudaStream_t st = (cudaStream_t)stream;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  if (plan == COND_PLAN_TC) {
    MmaLaunch L = {};
    L.n = 1;
    L.M = N * B;
    L.inner = B;
    MmaProduct& p = L.p[0];
    p.X = cond;
    p.x_k = (long long)B * COND;
    p.x_outer = (long long)K * B * COND;
    p.ldx = COND;
    p.W = w_ih_t + (size_t)Z1 * G;
    p.w_k = (long long)(Z1 + COND) * G;
    p.IN = COND;
    p.NC = G;
    p.bias = b_ih;
    p.out = gc;
    p.out_k = (long long)B * G;
    p.out_outer = (long long)K * B * G;
    p.leaky = 1;
    err = cond_gates_tc(L, K, mode, tile, d, st);
  } else {
    err = cond_gates_simt(cond, w_ih_t, b_ih, gc, B, N, K, Z1, COND, G, mode, tile, d, st);
  }
  if (err == cudaSuccess) *plan_out = plan;
  return (int)err;
}

// The gate products of many rows on the tensor cores, for Hopper (sm_90a):
//   out[k, m, :] = act(X[k, m, :]) @ W[k] (+ bias[k]) (+ addend[k, m, :])
// for every flow step k and row m of up to two products in one launch. Two
// kernels take it: cond_gates.cu (the training forward's conditioning gates,
// 14,336 rows a step for final_model) and sample_gates.cuh's many-row plan
// (the sampling gates from 16 or 64 rows on).
//
// Replaces: the `gi`, `gh` and own-face projection dots of
// lets_face_it_tpu/ops/pallas_train.py::_fwd_kernel and
// lets_face_it_tpu/ops/pallas_flow.py::_kernel / ::_seq_rev_kernel, which
// the TPU runs on its matrix unit.
//
// What bounds it on an H100: at the training shape (16 products of
// [14,336 x 512] @ [512 x 384]) the 822 MB it reads and writes, 0.25 ms at
// 3.35 TB/s, against 90 GFLOP (0.18 ms at TF32's 495 TFLOP/s, 0.09 at
// bf16's 989); at the sampling shape (B = 128) the arithmetic, 1.6 GFLOP.
//
// Design: a block computes a BM x BN tile of one product of one step; warps
// tile it WM x WN, each with mma.sync (m16n8k8 TF32, or m16n8k16 bf16) on
// fragments read from shared memory (the TF32 A fragments by ldmatrix).
// Both operands are staged by cp.async
// in a ring of STAGES tiles of depth BK = 32, zero-filled past every edge
// (rows, depth and columns need only be multiples of 4). Strides of the staged tiles are padded per
// mode so that every fragment read is free of bank conflicts. The
// activation (leaky_relu as max(x, 0.01 x)) and the mode's rounding
// (flow_step.cuh::round_operand's: RNA to TF32 as cvt.rna.tf32.f32, RNE to
// bf16 as the fragments are packed) are applied in registers as a
// fragment is read, so the tensor core, which would truncate a float32
// operand to TF32, gets values on the grid and its products are exact.
// Weights the caller rounded already (the prepared sets) are fed as they
// are at TF32; a product whose weights are not (the own-face slice) is
// launched with ROUND_W.
//
// At "highest" (FLOW_F32) the same tiles run a 3xTF32 split: x = hi + lo,
// both TF32, and per chunk of 8 depths lo*hi + hi*lo + hi*hi on the tensor
// cores from a zero accumulator, added to a float32 accumulator with
// round-to-nearest. The dropped lo*lo and lo's own rounding are 2^-22 of a
// product; summing each chunk apart keeps the tensor core's truncating
// accumulation off the running sum, whose float32 additions are then 8x
// fewer than a chain of FMAs makes (chip_smoke.py holds its rms from a
// float64 product against the plain float32 version's).
//
// Included by cond_gates.cu and sample_gates.cuh; it allocates nothing and
// launches on the caller's stream.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flow_step.cuh"

namespace {

constexpr int MMA_BK = 32;
constexpr int MMA_STAGES = 3;
constexpr int MMA_MAX_PRODUCTS = 2;

// One product: rows m < M are (m / inner, m % inner); row m of X is at
// X + k*x_k + (m / inner)*x_outer + (m % inner)*ldx, row m of out (and of
// addend) at out + k*out_k + (m / inner)*out_outer + (m % inner)*NC. W[k]
// is [IN, NC] row-major at W + k*w_k; bias [K, NC]. IN % 4 == 0,
// NC % 4 == 0, ldx % 4 == 0, every pointer 16-byte aligned.
struct MmaProduct {
  const float* X;
  long long x_k, x_outer;
  int ldx;
  const float* W;
  long long w_k;
  int IN, NC;
  const float* bias;     // or null
  const float* addend;   // or null
  long long add_k, add_outer;
  float* out;
  long long out_k, out_outer;
  int leaky;
  int col_tiles;         // ceil(NC / BN), set by mma_enqueue
};

struct MmaLaunch {
  MmaProduct p[MMA_MAX_PRODUCTS];
  int n;
  int M, inner;          // rows of every product, and rows per outer index
  int blocks0;           // grid.x blocks of product 0 (K * its col_tiles)
};

template <int MODE>
struct MmaShape {
  static constexpr int KSTEP = MODE == FLOW_BF16 ? 16 : 8;
  // staged strides (floats): conflict-free fragment reads per mode
  static constexpr int APAD = MODE == FLOW_BF16 ? 8 : 4;
  static constexpr int BPAD = MODE == FLOW_BF16 ? 4 : 8;
};

template <int MODE, int BM, int BN>
__host__ __device__ constexpr int mma_stage_floats() {
  return BM * (MMA_BK + MmaShape<MODE>::APAD) + MMA_BK * (BN + MmaShape<MODE>::BPAD);
}

template <int MODE, int BM, int BN, int STAGES>
__host__ __device__ constexpr int mma_smem_bytes() {
  return STAGES * mma_stage_floats<MODE, BM, BN>() * (int)sizeof(float);
}

__device__ __forceinline__ void mma_cp16(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// x rounded to TF32 (RNA) as an mma operand: the tensor core reads the top
// 19 bits, so the low ones need no clearing
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (hi the nearest, lo the nearest to the rest)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = round_operand<FLOW_TF32>(x);
  hi = __float_as_uint(h);
  lo = tf32_rna(x - h);
}

__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four 8 x 4 float blocks of an m16n8k8 A fragment (rows 0-7 and 8-15,
// depths 0-3 and 4-7 from `row0`, a row `stride` floats apart) by one
// ldmatrix: lane l gives the address of row l % 8 of block l / 8, and
// receives a0..a3 as the TF32 mma reads them.
__device__ __forceinline__ void ldsm_a(uint32_t (&r)[4], const float* row0, int stride,
                                       int lane) {
  const int q = lane / 8;
  const float* p = row0 + ((q & 1) * 8 + lane % 8) * stride + (q >> 1) * 4;
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// leaky_relu (slope 0.01) or the identity (slope 1): max(x, slope * x)
__device__ __forceinline__ float act(float x, float slope) {
  return fmaxf(x, slope * x);
}

// A block: product, step and column tile by blockIdx.x, row tile by
// blockIdx.y. WM x WN warp tiles, (BM / WM) x (BN / WN) warps; STAGES
// tiles of depth MMA_BK in flight. ROUND_W (TF32 only): round the weight
// operand as its fragment is read (a product whose weights the caller did
// not round); bf16 fragments are rounded as they are packed, and the 3xTF32
// split takes float32 weights.
template <int MODE, int BM, int BN, int WM, int WN, int STAGES, bool ROUND_W>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
gates_mma_kernel(MmaLaunch L) {
  using S = MmaShape<MODE>;
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  constexpr int SA = MMA_BK + S::APAD, SB = BN + S::BPAD;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int A_CHUNKS = BM * (MMA_BK / 4) / THREADS;   // 16-byte chunks a thread
  constexpr int B_CHUNKS = MMA_BK * (BN / 4) / THREADS;
  static_assert(A_CHUNKS * THREADS == BM * (MMA_BK / 4), "A tile / threads");
  static_assert(B_CHUNKS * THREADS == MMA_BK * (BN / 4), "B tile / threads");
  extern __shared__ __align__(16) float msm[];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  int blk = blockIdx.x;
  const bool second = blk >= L.blocks0;
  if (second) blk -= L.blocks0;
  const MmaProduct P = second ? L.p[1] : L.p[0];
  const int k = blk / P.col_tiles;
  const int n0 = (blk - k * P.col_tiles) * BN;
  const int m0 = blockIdx.y * BM;
  const int IN = P.IN, NC = P.NC;
  const float* W = P.W + (size_t)k * P.w_k;
  const float slope = P.leaky ? 0.01f : 1.0f;

  // this thread's A rows (null past M) and its chunk column
  const int aq = tid % (MMA_BK / 4);
  const float* a_row[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) {
    const int m = m0 + tid / (MMA_BK / 4) + i * (THREADS / (MMA_BK / 4));
    a_row[i] = nullptr;
    if (m < L.M) {
      const int o = m / L.inner, r = m - o * L.inner;
      a_row[i] = P.X + (size_t)k * P.x_k + (size_t)o * P.x_outer + (size_t)r * P.ldx;
    }
  }

  auto a_tile = [&](int s) { return msm + s * mma_stage_floats<MODE, BM, BN>(); };
  auto b_tile = [&](int s) { return a_tile(s) + BM * SA; };

  auto load = [&](int s, int kt) {
    const int k0 = kt * MMA_BK;
    float* As = a_tile(s);
    float* Bs = b_tile(s);
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int r = tid / (MMA_BK / 4) + i * (THREADS / (MMA_BK / 4));
      const bool ok = a_row[i] != nullptr && k0 + 4 * aq < IN;
      mma_cp16(As + r * SA + 4 * aq, ok ? a_row[i] + k0 + 4 * aq : P.X, ok);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int kk = c / (BN / 4), q = c % (BN / 4);
      const bool ok = k0 + kk < IN && n0 + 4 * q < NC;
      mma_cp16(Bs + kk * SB + 4 * q, ok ? W + (size_t)(k0 + kk) * NC + n0 + 4 * q : W, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // one staged tile: fragments read from shared memory, the activation and
  // the mode's rounding applied in registers
  auto compute = [&](int s) {
    const float* As = a_tile(s) + (wm * WM) * SA;
    const float* Bs = b_tile(s) + wn * WN;
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += S::KSTEP) {
      if constexpr (MODE == FLOW_BF16) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* r0 = As + (i * 16 + g) * SA + kk + 2 * t;
          const float* r1 = r0 + 8 * SA;
          const float2 x0 = *reinterpret_cast<const float2*>(r0);
          const float2 x1 = *reinterpret_cast<const float2*>(r1);
          const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 x3 = *reinterpret_cast<const float2*>(r1 + 8);
          a[i][0] = bf16_pack(act(x0.x, slope), act(x0.y, slope));
          a[i][1] = bf16_pack(act(x1.x, slope), act(x1.y, slope));
          a[i][2] = bf16_pack(act(x2.x, slope), act(x2.y, slope));
          a[i][3] = bf16_pack(act(x3.x, slope), act(x3.y, slope));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* c0 = Bs + (kk + 2 * t) * SB + j * 8 + g;
          const uint32_t b0 = bf16_pack(c0[0], c0[SB]);
          const uint32_t b1 = bf16_pack(c0[8 * SB], c0[9 * SB]);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
        }
      } else if constexpr (MODE == FLOW_TF32) {
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          ldsm_a(a[i], As + i * 16 * SA + kk, SA, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = tf32_rna(act(__uint_as_float(a[i][e]), slope));
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* c0 = Bs + (kk + t) * SB + j * 8 + g;
          uint32_t b0 = __float_as_uint(c0[0]), b1 = __float_as_uint(c0[4 * SB]);
          if constexpr (ROUND_W) {
            b0 = tf32_rna(c0[0]);
            b1 = tf32_rna(c0[4 * SB]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], a[i], b0, b1);
        }
      } else {   // FLOW_F32: 3xTF32, each chunk of 8 summed apart
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t x[4];
          ldsm_a(x, As + i * 16 * SA + kk, SA, lane);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tf32_split(act(__uint_as_float(x[e]), slope), ah[i][e], al[i][e]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* c0 = Bs + (kk + t) * SB + j * 8 + g;
          uint32_t bh0, bl0, bh1, bl1;
          tf32_split(c0[0], bh0, bl0);
          tf32_split(c0[4 * SB], bh1, bl1);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(d, al[i], bh0, bh1);
            mma_tf32(d, ah[i], bl0, bl1);
            mma_tf32(d, ah[i], bh0, bh1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
          }
        }
      }
    }
  };

  // the cp.async ring: STAGES - 1 tiles ahead of the one computed
  const int tiles = (IN + MMA_BK - 1) / MMA_BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s, s);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int kt = 0; kt < tiles; ++kt) {
    asm volatile("cp.async.wait_group %0;" ::"n"(STAGES - 2) : "memory");
    __syncthreads();   // tile kt visible to all; tile kt - 1's slot free
    const int pre = kt + STAGES - 1;
    if (pre < tiles) load(pre % STAGES, pre);
    asm volatile("cp.async.commit_group;" ::: "memory");
    compute(kt % STAGES);
  }

  // epilogue: bias and addend, float2 stores (NC % 4 == 0: a pair of
  // columns is wholly in or out)
  const float* bias = P.bias ? P.bias + (size_t)k * NC : nullptr;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * WM + i * 16 + g + 8 * h;
      if (m >= L.M) continue;
      const int o = m / L.inner, r = m - o * L.inner;
      const size_t row = (size_t)r * NC;
      float* out = P.out + (size_t)k * P.out_k + (size_t)o * P.out_outer + row;
      const float* add = P.addend
          ? P.addend + (size_t)k * P.add_k + (size_t)o * P.add_outer + row : nullptr;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * t;
        if (n >= NC) continue;
        float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        if (bias) {
          const float2 bv = *reinterpret_cast<const float2*>(bias + n);
          v.x += bv.x;
          v.y += bv.y;
        }
        if (add) {
          const float2 av = *reinterpret_cast<const float2*>(add + n);
          v.x += av.x;
          v.y += av.y;
        }
        *reinterpret_cast<float2*>(out + n) = v;
      }
    }
  }
  // a chain launched after this kernel may start its set-up now; it reads
  // these results only once the whole grid has finished
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// One launch over K steps of the products of L (col_tiles and blocks0 set
// here) with tile <BM, BN, WM, WN, STAGES> at matmul precision MODE;
// round_w: a product's weights need rounding (TF32 only).
template <int MODE, int BM, int BN, int WM, int WN, int STAGES, bool ROUND_W>
inline cudaError_t mma_enqueue_tile(MmaLaunch L, int K, const FlowDevice& d,
                                    cudaStream_t stream) {
  constexpr int THREADS = (BM / WM) * (BN / WN) * 32;
  constexpr int SMEM = mma_smem_bytes<MODE, BM, BN, STAGES>();
  static bool allowed[FLOW_MAX_DEVICES] = {};
  auto kernel = gates_mma_kernel<MODE, BM, BN, WM, WN, STAGES, ROUND_W>;
  if (SMEM > d.max_smem) return (cudaError_t)FLOW_ERR_PLAN;
  cudaError_t err = allow_max_smem(kernel, d, allowed);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  for (int i = 0; i < L.n; ++i) {
    L.p[i].col_tiles = (L.p[i].NC + BN - 1) / BN;
    if (i == 0) L.blocks0 = K * L.p[i].col_tiles;
    blocks += K * L.p[i].col_tiles;
  }
  const long long row_tiles = (L.M + BM - 1) / BM;
  if (row_tiles > 65535) return (cudaError_t)FLOW_ERR_ARGS;
  kernel<<<dim3(blocks, (unsigned)row_tiles), THREADS, SMEM, stream>>>(L);
  return cudaGetLastError();
}

// Runtime matmul precision -> instantiation, for one tile; round_w: the
// weights of some product are not rounded for `mode` yet.
template <int BM, int BN, int WM, int WN, int STAGES>
inline cudaError_t mma_enqueue(const MmaLaunch& L, int K, int mode, bool round_w,
                               const FlowDevice& d, cudaStream_t stream) {
  switch (mode) {
    case FLOW_F32:
      return mma_enqueue_tile<FLOW_F32, BM, BN, WM, WN, STAGES, false>(L, K, d, stream);
    case FLOW_TF32:
      return round_w
          ? mma_enqueue_tile<FLOW_TF32, BM, BN, WM, WN, STAGES, true>(L, K, d, stream)
          : mma_enqueue_tile<FLOW_TF32, BM, BN, WM, WN, STAGES, false>(L, K, d, stream);
    case FLOW_BF16:
      return mma_enqueue_tile<FLOW_BF16, BM, BN, WM, WN, STAGES, false>(L, K, d, stream);
    default: return (cudaError_t)FLOW_ERR_ARGS;
  }
}

}  // namespace

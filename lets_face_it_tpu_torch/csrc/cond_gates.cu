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
// What bounds it on an H100: a float32 product, per step k, of
// [N * B, COND] @ [COND, 3H]; for final_model at B = 256, N = 56 that is
// 14,336 rows x 512 x 384 x 16 steps = 90.2 GFLOP, 1.35 ms at the 67 TFLOP/s
// of float32 FMA; it reads 470 MB of cond and writes 352 MB of gc (0.25 ms
// at 3.35 TB/s). Bound by operations.
//
// Design: a register-tiled SIMT GEMM, batched over k by blockIdx.z. A block
// of 256 threads computes a 128 x 128 tile of gc; each thread an 8 x 8
// sub-tile (two 4-row by two 4-column quarters, so that its shared-memory
// reads are 16-byte and the warp's are free of bank conflicts). Operand
// tiles of depth 8 are double-buffered in shared memory: the weight tile by
// cp.async (zero-filled past the edge), the cond tile through registers,
// where leaky_relu is applied and the tile is transposed as it is stored.
// The bias is added in the epilogue. At a reduced matmul precision (mode,
// flow_step.cuh::FlowPrecision) the activation is rounded with leaky_relu,
// before it is stored; the wrapper hands the weights rounded. The rows of
// one k are strided in cond
// and gc ([N, K, B, *]); the kernel maps row m = t * B + b itself. This file
// allocates nothing and launches on the caller's stream.

#include <cstdint>

#include <cuda_runtime.h>

#include "flow_step.cuh"

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

}  // namespace

extern "C" int cond_gates_launch(const float* cond, const float* w_ih_t,
                                 const float* b_ih, float* gc, int B, int N,
                                 int K, int Z1, int COND, int H, int mode,
                                 void* stream) {
  const int G = 3 * H;
  if (B < 1 || N < 1 || K < 1 || COND % 4 != 0 || G % 4 != 0 || Z1 < 0
      || !precision_valid(mode)
      || (long long)N * B >= (1LL << 31) / BM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N * B + BM - 1) / BM, (G + BN - 1) / BN, K);
  cond_gates_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cond, w_ih_t, b_ih, gc, B, N, K, Z1, COND, G, mode);
  return (int)cudaGetLastError();
}

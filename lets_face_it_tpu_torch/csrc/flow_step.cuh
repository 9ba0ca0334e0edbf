// What every flow kernel shares: the weight set, the device's properties as
// the launchers read them, the launch helpers and the pointwise functions.
// The training kernels (seq_fwd.cu, seq_bwd.cu, via flow_stream.cuh) and the
// sampling kernels (sample_gates.cuh, sample_chain.cuh) include it.
//
// All arithmetic of the kernels is float32 with fused multiply-adds on the
// CUDA cores. The matmul precision of a launch (FlowPrecision, the JAX
// package's Precision.HIGHEST / HIGH / DEFAULT) rounds the operands of the
// products only: the kernels round each activation operand as they load it
// (round_operand), and take the weight operands rounded once in the same way
// (ops/flow_kernels.py::round_operand), or, in the sampling gates kernel,
// round them as they load them too. A product of two
// bf16 or TF32 values is exact in float32, so the float32 sums give what a
// tensor core would give, up to the order of the sum.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Largest batch tile the serial kernels are instantiated for
// (FLOW_DISPATCH_BT).
constexpr int FLOW_MAX_BT = 8;
// Devices whose properties the launchers cache.
constexpr int FLOW_MAX_DEVICES = 64;
// Refusals of the sampling launchers, apart from CUDA's own error codes.
constexpr int FLOW_ERR_ARGS = 10001;   // widths or shapes the kernels do not take
constexpr int FLOW_ERR_PLAN = 10002;   // no launch plan fits the device

struct FlowWeights {
  const float* w_ih_t;   // [K, Z1 + COND, 3H]
  const float* w_hh_t;   // [K, H, 3H]
  const float* b_ih;     // [K, 3H]
  const float* b_hh;     // [K, 3H]
  const float* out_w_t;  // [K, H, COUT]  columns [shift | scale_raw]
  const float* out_b;    // [K, COUT]
  const float* w_mix;    // [K, C, C]     P L U (training)
  const float* an_bias;  // [K, C]
  const float* an_mul;   // [K, C]        exp(logs) (training)
  int K, C, Z1, COND, H, COUT;
  float scale_eps;
};

// The training backward's transposed weights (laid out by the wrapper,
// ops/train_kernels.py::seq_bwd).
struct BwdWeights {
  const float* w_t;       // [K, C, C]     W^T
  const float* w_hh;      // [K, 3H, H]    w_hh_t^T
  const float* w_ih_z1;   // [K, 3H, Z1]   w_ih_t[:, :Z1]^T
  const float* out_w;     // [K, COUT, H]  out_w_t^T
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// The current device's SM count, opt-in shared memory per block and L2
// cache (bytes), read once per device.
struct FlowDevice {
  int sms;
  int max_smem;
  int l2_bytes;
};

inline cudaError_t flow_device(FlowDevice* out) {
  static FlowDevice cache[FLOW_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < FLOW_MAX_DEVICES && cache[dev].sms > 0) {
    *out = cache[dev];
    return cudaSuccess;
  }
  FlowDevice d;
  err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&d.l2_bytes, cudaDevAttrL2CacheSize, dev);
  if (err != cudaSuccess) return err;
  if (dev < FLOW_MAX_DEVICES) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

// Raises `kernel`'s dynamic shared-memory cap to the device's limit, once per
// device (`done` is the kernel's own flag array).
template <typename Kernel>
inline cudaError_t allow_max_smem(Kernel kernel, const FlowDevice& d,
                                  bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < FLOW_MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d.max_smem);
  if (err == cudaSuccess && dev < FLOW_MAX_DEVICES) done[dev] = true;
  return err;
}

// Every product's output width is a multiple of 4 (float4 weight loads).
__host__ __device__ inline bool widths_vec4(const FlowWeights& w) {
  return (3 * w.H) % 4 == 0 && w.COND % 4 == 0 && w.COUT % 4 == 0
         && w.C % 4 == 0;
}

// The matmul precision of a launch (ops/flow_kernels.py::MODES).
enum FlowPrecision : int {
  FLOW_F32 = 0,    // "highest": float32 operands
  FLOW_TF32 = 1,   // "high": operands rounded to TF32 (10 mantissa bits,
                   // nearest, ties away from zero)
  FLOW_BF16 = 2,   // "medium": operands rounded to bf16 (nearest even)
};

template <int MODE>
__device__ __forceinline__ float round_operand(float x) {
  if constexpr (MODE == FLOW_TF32) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return __uint_as_float(r & 0xffffe000u);
  } else if constexpr (MODE == FLOW_BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <int MODE>
__device__ __forceinline__ float4 round_operand(float4 v) {
  return make_float4(round_operand<MODE>(v.x), round_operand<MODE>(v.y),
                     round_operand<MODE>(v.z), round_operand<MODE>(v.w));
}

// The same with the mode as a launch argument, for operands rounded once as
// they are staged (outside the products' loops).
__device__ __forceinline__ float round_operand(float x, int mode) {
  return mode == FLOW_TF32   ? round_operand<FLOW_TF32>(x)
         : mode == FLOW_BF16 ? round_operand<FLOW_BF16>(x)
                             : x;
}

__device__ __forceinline__ float4 round_operand(float4 v, int mode) {
  return make_float4(round_operand(v.x, mode), round_operand(v.y, mode),
                     round_operand(v.z, mode), round_operand(v.w, mode));
}

__host__ __device__ inline bool precision_valid(int mode) {
  return mode == FLOW_F32 || mode == FLOW_TF32 || mode == FLOW_BF16;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float leaky_relu_(float x) {
  return x >= 0.0f ? x : 0.01f * x;
}

// Runtime batch-tile size (a power of two up to FLOW_MAX_BT) -> template
// instantiation.
#define FLOW_DISPATCH_BT(bt, ...)                      \
  switch (bt) {                                        \
    case 1: { constexpr int BT = 1; __VA_ARGS__; break; } \
    case 2: { constexpr int BT = 2; __VA_ARGS__; break; } \
    case 4: { constexpr int BT = 4; __VA_ARGS__; break; } \
    case 8: { constexpr int BT = 8; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;        \
  }

// Runtime matmul precision -> template instantiation (MODE).
#define FLOW_DISPATCH_MODE(mode, ...)                                   \
  switch (mode) {                                                       \
    case FLOW_F32: { constexpr int MODE = FLOW_F32; __VA_ARGS__; break; }   \
    case FLOW_TF32: { constexpr int MODE = FLOW_TF32; __VA_ARGS__; break; } \
    case FLOW_BF16: { constexpr int MODE = FLOW_BF16; __VA_ARGS__; break; } \
    default: return (int)cudaErrorInvalidValue;                         \
  }

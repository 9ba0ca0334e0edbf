// One reversed flow step for a tile of BT batch rows, shared by the per-frame
// kernel (frame_rev.cu) and the whole-sequence kernel (seq_rev.cu); the
// tile product, the scratch layout and the launch helpers are shared with
// the training kernels too (seq_fwd.cu, seq_bwd.cu).
//
// Step k inverts   actnorm -> 1x1 (W = P L U) -> affine coupling(GRU)   for
// BT rows held in shared memory:
//   rnn_in = [z1 | leaky_relu(proj_k)]          (the caller fills proj_k)
//   h      = GRU(rnn_in, h_prev)                (gate order r, z, n)
//   hout   = h @ out_w_t[k] + out_b[k]          ([shift | scale_raw] halves)
//   z2     = z2 / max(sigmoid(scale_raw + 2), eps) - shift
//   z      = (z @ W^-1[k]) * exp(-logs[k]) - bias[k]
//
// All arithmetic is float32 with fused multiply-adds; no tensor cores, so no
// TF32 rounding. Every product of the step is a tile matrix-vector product
// [BT, IN] @ [IN, NC] with the weight in device memory (L2) and the rows in
// shared memory; tile_matvec splits it over the whole block: a thread owns
// four neighbouring output columns (one 16-byte load per weight row, so a
// warp reads 512 contiguous bytes) of one slice of the IN rows, and the
// slices' partial sums meet in shared memory. Each weight element is read
// once per block and step and reused for the BT rows in registers.

#pragma once

#include <cuda_runtime.h>

// Threads per block of both kernels (__launch_bounds__ holds each thread to
// 64 registers so that 1024 of them fit one SM).
constexpr int FLOW_THREADS = 1024;
// Slices the partial-sum buffer is sized for (fewer when it does not fit).
constexpr int FLOW_MAX_SLICES = 16;
// Largest batch tile the kernels are instantiated for (FLOW_DISPATCH_BT).
constexpr int FLOW_MAX_BT = 8;
// Devices whose properties the launchers cache.
constexpr int FLOW_MAX_DEVICES = 64;

struct FlowWeights {
  const float* w_ih_t;   // [K, Z1 + COND, 3H]
  const float* w_hh_t;   // [K, H, 3H]
  const float* b_ih;     // [K, 3H]
  const float* b_hh;     // [K, 3H]
  const float* out_w_t;  // [K, H, COUT]  columns [shift | scale_raw]
  const float* out_b;    // [K, COUT]
  const float* w_mix;    // [K, C, C]     (P L U)^-1 sampling, P L U training
  const float* an_bias;  // [K, C]
  const float* an_mul;   // [K, C]        exp(-logs) sampling, exp(logs) training
  int K, C, Z1, COND, H, COUT;
  float scale_eps;
};

// Per-block scratch in shared memory (BT rows each).
struct StepScratch {
  float* z;        // [BT, C]
  float* ztmp;     // [BT, C]
  float* rnn_in;   // [BT, Z1 + COND]
  float* gi;       // [BT, 3H]
  float* gh;       // [BT, 3H]
  float* hout;     // [BT, COUT]
  float* partial;  // [slices, BT, widest]
  int partial_floats;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// Floats of the fixed part of the step scratch (every piece padded to 4 so
// that each starts 16-byte aligned).
__host__ __device__ inline int step_fixed_floats(int bt, const FlowWeights& w) {
  return 2 * round4(bt * w.C) + round4(bt * (w.Z1 + w.COND))
         + 2 * round4(bt * 3 * w.H) + round4(bt * w.COUT);
}

// Output width of the widest tile product either kernel runs (the GRU gates,
// or the conditioning projection of seq_rev.cu).
__host__ __device__ inline int widest_product(const FlowWeights& w) {
  const int g = 3 * w.H;
  return g > w.COND ? g : w.COND;
}

// Partial-sum floats: FLOW_MAX_SLICES slices of the widest product, or what
// is left of `max_smem` bytes after `other_floats`; 0 if not even one fits.
__host__ __device__ inline int partial_floats_for(int bt, int widest,
                                                  int other_floats,
                                                  int max_smem) {
  const int left = max_smem / 4 - other_floats;
  const int want = FLOW_MAX_SLICES * bt * widest;
  const int got = (want < left ? want : left) / 4 * 4;
  return got >= bt * widest ? got : 0;
}

// The current device's SM count and opt-in shared memory per block (bytes),
// read once per device.
struct FlowDevice {
  int sms;
  int max_smem;
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
  if (err != cudaSuccess) return err;
  if (dev < FLOW_MAX_DEVICES) cache[dev] = d;
  *out = d;
  return cudaSuccess;
}

// Batch rows per block: enough blocks to cover the SMs, as few rows per block
// as that allows (each block re-reads the weights), and the most that fit the
// device's shared memory. other_floats(bt) is the block's shared memory
// besides the partial sums. 0 if not even one row fits.
template <typename OtherFloats>
inline int pick_bt(int B, int widest, const FlowDevice& d,
                   OtherFloats other_floats) {
  int bt = 1;
  while (bt < FLOW_MAX_BT && bt * d.sms < B) bt *= 2;
  while (bt > 0 &&
         partial_floats_for(bt, widest, other_floats(bt), d.max_smem) == 0)
    bt /= 2;
  return bt;
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

__device__ inline StepScratch carve_step_scratch(float* base, int bt,
                                                 const FlowWeights& w,
                                                 int partial_floats) {
  StepScratch s;
  s.z = base;
  s.ztmp = s.z + round4(bt * w.C);
  s.rnn_in = s.ztmp + round4(bt * w.C);
  s.gi = s.rnn_in + round4(bt * (w.Z1 + w.COND));
  s.gh = s.gi + round4(bt * 3 * w.H);
  s.hout = s.gh + round4(bt * 3 * w.H);
  s.partial = s.hout + round4(bt * w.COUT);
  s.partial_floats = partial_floats;
  return s;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float leaky_relu_(float x) {
  return x >= 0.0f ? x : 0.01f * x;
}

// out[r, c] = act(bias[c] + addend[r, c] + sum_i X[r, i] * W[i, c]) for the
// BT rows of the tile; NC % 4 == 0 and W 16-byte aligned. `addend` (device
// memory, row stride NC, only its first `rows` rows are read) and `bias` may
// be null; IN may be 0. Starts and ends synchronised.
template <int BT>
__device__ void tile_matvec(const float* __restrict__ W, int IN, int NC,
                            const float* X, int ldx,
                            const float* __restrict__ bias,
                            const float* __restrict__ addend, int rows,
                            bool leaky, float* out, int ldo,
                            const StepScratch& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int groups = NC / 4;
  int slices = nt / groups;
  if (slices * BT * NC > s.partial_floats) slices = s.partial_floats / (BT * NC);
  if (slices > IN) slices = IN;
  if (slices < 1) slices = 1;   // IN == 0: one slice of zeros
  const int chunk = (IN + slices - 1) / slices;

  __syncthreads();   // X is complete
  for (int job = tid; job < groups * slices; job += nt) {
    const int cg = job % groups, sl = job / groups;
    const int i0 = sl * chunk;
    const int i1 = min(IN, i0 + chunk);
    float4 acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* wp = reinterpret_cast<const float4*>(W) + cg;
#pragma unroll 4
    for (int i = i0; i < i1; ++i) {
      const float4 wv = __ldg(wp + (size_t)i * groups);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float x = X[r * ldx + i];
        acc[r].x = fmaf(x, wv.x, acc[r].x);
        acc[r].y = fmaf(x, wv.y, acc[r].y);
        acc[r].z = fmaf(x, wv.z, acc[r].z);
        acc[r].w = fmaf(x, wv.w, acc[r].w);
      }
    }
    float4* pp = reinterpret_cast<float4*>(s.partial) + cg;
#pragma unroll
    for (int r = 0; r < BT; ++r) pp[(sl * BT + r) * groups] = acc[r];
  }
  __syncthreads();
  for (int idx = tid; idx < BT * NC; idx += nt) {
    const int r = idx / NC, c = idx - r * NC;
    float v = bias ? bias[c] : 0.0f;
    if (addend && r < rows) v += addend[(size_t)r * NC + c];
    for (int sl = 0; sl < slices; ++sl) v += s.partial[(sl * BT + r) * NC + c];
    out[r * ldo + c] = leaky ? leaky_relu_(v) : v;
  }
  __syncthreads();
}

// Reverse step k on the tile. On entry s.z holds z and
// s.rnn_in[:, Z1:] holds leaky_relu(proj_k); h holds the step's GRU state
// [BT, H] and is overwritten with the new state. Ends synchronised.
template <int BT>
__device__ void reverse_step(const FlowWeights& w, int k, const StepScratch& s,
                             float* h) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int C = w.C, Z1 = w.Z1, H = w.H, COUT = w.COUT;
  const int IN = Z1 + w.COND;
  const int G = 3 * H;

  __syncthreads();   // the caller's writes of z, proj_k and h are visible
  for (int idx = tid; idx < BT * Z1; idx += nt) {
    const int r = idx / Z1, j = idx - r * Z1;
    s.rnn_in[r * IN + j] = s.z[r * C + j];
  }
  tile_matvec<BT>(w.w_ih_t + (size_t)k * IN * G, IN, G, s.rnn_in, IN,
                  w.b_ih + k * G, nullptr, 0, false, s.gi, G, s);
  tile_matvec<BT>(w.w_hh_t + (size_t)k * H * G, H, G, h, H,
                  w.b_hh + k * G, nullptr, 0, false, s.gh, G, s);

  for (int idx = tid; idx < BT * H; idx += nt) {
    const int r = idx / H, j = idx - r * H;
    const float* gi = s.gi + r * G;
    const float* gh = s.gh + r * G;
    const float rg = sigmoidf_(gi[j] + gh[j]);
    const float zg = sigmoidf_(gi[H + j] + gh[H + j]);
    const float ng = tanhf(gi[2 * H + j] + rg * gh[2 * H + j]);
    h[idx] = (1.0f - zg) * ng + zg * h[idx];
  }
  tile_matvec<BT>(w.out_w_t + (size_t)k * H * COUT, H, COUT, h, H,
                  w.out_b + k * COUT, nullptr, 0, false, s.hout, COUT, s);

  const int half = COUT / 2;   // == C - Z1 for the affine coupling
  for (int idx = tid; idx < BT * half; idx += nt) {
    const int r = idx / half, j = idx - r * half;
    const float shift = s.hout[r * COUT + j];
    const float scale = fmaxf(sigmoidf_(s.hout[r * COUT + half + j] + 2.0f),
                              w.scale_eps);
    float* z2 = s.z + r * C + Z1 + j;
    *z2 = *z2 / scale - shift;
  }
  tile_matvec<BT>(w.w_mix + (size_t)k * C * C, C, C, s.z, C,
                  nullptr, nullptr, 0, false, s.ztmp, C, s);
  for (int idx = tid; idx < BT * C; idx += nt) {
    const int c = idx % C;
    s.z[idx] = s.ztmp[idx] * w.an_mul[k * C + c] - w.an_bias[k * C + c];
  }
  __syncthreads();
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

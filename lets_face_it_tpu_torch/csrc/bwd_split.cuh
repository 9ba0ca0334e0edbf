// The backward's two products that read w_hh, taken off the hidden split's
// serial walk (seq_bwd_hsplit.cu): neither is on the dz chain inside a
// frame, so each runs as a tile product over the whole card.

#pragma once

#include "flow_step.cuh"
#include "gates_mma.cuh"

namespace {

// The tile products (gates_mma.cuh, the weights rounded for `mode` by the
// caller).
template <int BM, int BN, int WM, int WN, int STAGES>
cudaError_t bwd_mma(const MmaLaunch& L, int K, int mode, const FlowDevice& d,
                    cudaStream_t st) {
  switch (mode) {
    case FLOW_F32:
      return mma_enqueue_tile<FLOW_F32, BM, BN, WM, WN, STAGES, false>(L, K, d, st);
    case FLOW_TF32:
      return mma_enqueue_tile<FLOW_TF32, BM, BN, WM, WN, STAGES, false>(L, K, d, st);
    case FLOW_BF16:
      return mma_enqueue_tile<FLOW_BF16, BM, BN, WM, WN, STAGES, false>(L, K, d, st);
    default: return (cudaError_t)FLOW_ERR_ARGS;
  }
}

// gh[t, k] = hprev[t, k] @ w_hh_t[k] + b_hh[k] for every frame and step:
// [N * B, H] @ [H, 3H] per step, in cond_gates.cu's 128 x 128 tiles.
cudaError_t bwd_gh(const FlowWeights& w, const float* hprev, float* gh, int B,
                   int N, int mode, const FlowDevice& d, cudaStream_t st) {
  const int K = w.K, H = w.H, G = 3 * H;
  MmaLaunch L = {};
  L.n = 1;
  L.M = N * B;
  L.inner = B;
  MmaProduct& p = L.p[0];
  p.X = hprev;
  p.x_k = (long long)B * H;
  p.x_outer = (long long)K * B * H;
  p.ldx = H;
  p.W = w.w_hh_t;
  p.w_k = (long long)H * G;
  p.IN = H;
  p.NC = G;
  p.bias = w.b_hh;
  p.out = gh;
  p.out_k = (long long)B * G;
  p.out_outer = (long long)K * B * G;
  return bwd_mma<128, 128, 32, 64, 3>(L, K, mode, d, st);
}

// One frame's state cotangents: dstate[k] = dhu[k] + dgh[k] @ w_hh[k],
// [B, 3H] @ [3H, H] for every k, in 64 x 64 tiles (128 blocks at B = 64,
// H = 512, K = 16).
cudaError_t bwd_dstate(const FlowWeights& w, const BwdWeights& wb, const float* dgh,
                       const float* dhu, float* dstate, int B, int mode,
                       const FlowDevice& d, cudaStream_t st) {
  const int K = w.K, H = w.H, G = 3 * H;
  MmaLaunch L = {};
  L.n = 1;
  L.M = B;
  L.inner = B;
  MmaProduct& p = L.p[0];
  p.X = dgh;
  p.x_k = (long long)B * G;
  p.ldx = G;
  p.W = wb.w_hh;
  p.w_k = (long long)G * H;
  p.IN = G;
  p.NC = H;
  p.addend = dhu;
  p.add_k = (long long)B * H;
  p.out = dstate;
  p.out_k = (long long)B * H;
  return bwd_mma<64, 64, 32, 32, 3>(L, K, mode, d, st);
}

}  // namespace

// Whole-sequence reverse flow for Hopper (sm_90a): offline generation.
//
// Replaces: lets_face_it_tpu/ops/pallas_flow.py::_seq_rev_kernel (the
// pallas_call in sequence_rev_fused), the autoregressive sampling loop. One
// call generates N frames: for each frame t the K flow steps are inverted in
// reverse order with
//   proj_k = fixed_projs[t, k] + hist @ w_p1_t[k]
// where hist [B, P1] is the flattened own-face history (oldest frame first);
// after each frame it drops its oldest C values and appends the new frame.
// The GRU states persist across frames. P1 = 0 (no own-face conditioning)
// leaves proj_k = fixed_projs[t, k] and skips the history.
//
// What bounds it on an H100: per frame the weights of the per-frame step
// plus w_p1 (K * P1 * COND * 4 B, 9.2 MB for final_model) are read, 25 MB in
// all, and fixed_projs [N, K, B, COND] is streamed once; about 13 MFLOP per
// batch row and frame. At B = 1 the bytes bound it, at B = 128 the
// operations; and the frames are serial, each one's K steps too.
//
// Design: the frame loop runs here, on the host, as three launches a frame
// on the caller's stream, so one call still generates the whole sequence:
//   1. sample_gates.cuh: proj[k] (with fixed_projs[t, k] added) and gh[k]
//      for all k, from the history and the states of the previous frame;
//   2. sample_gates.cuh: gc[k] = leaky_relu(proj[k]) @ w_ih_t[k][Z1:] + b_ih[k];
//   3. sample_chain.cuh: the K serial steps on a thread-block cluster that
//      holds the chain's weights in shared memory (or, where they do not
//      fit, the hidden split, sample_chain_hsplit.cuh, or part of them,
//      streaming the rest); it writes x_t, the new states (in
//      place: each block reads and writes only its own rows and, on the
//      hidden split, its own units) and the next history into the other of
//      two buffers. The next frame's gates read those states and that
//      history; launch 1 is an ordinary launch, so it starts only after
//      launch 3 has finished.
// Launches 1-2 read 24.9 of the frame's 26.3 MB of weights (final_model)
// with the whole card; the chain reads only its resident 1.36 MB, and its
// launch overlaps the end of launch 2. With P1 = 0, launches 1 and 2 are
// one (gh and gc together).
//
// `mode` is the matmul precision of every launch
// (flow_step.cuh::FlowPrecision). The wrapper
// (ops/flow_kernels.py::sequence_rev_fused) allocates the
// output and every scratch buffer (proj, gc, gh, the two histories, the
// running states); this file allocates nothing. It adds the gates and chain
// launches it makes to launches[0] and launches[1], the gates launches of
// the many-row plan to launches[2] and the chain's on the hidden split to
// launches[3] too, which the wrapper adds to their counters.

#include "sample_chain.cuh"
#include "sample_gates.cuh"

extern "C" int seq_rev_launch(
    const float* zs, const float* fixed_projs, const float* hist0,
    const float* w_p1_t, const float* states0, float* xs,
    const float* w_ih_t, const float* w_hh_t, const float* b_ih,
    const float* b_hh, const float* chain_w, const float* chain_hs,
    float* proj, float* gc, float* gh, float* hist_a, float* hist_b,
    float* states,
    int B, int N, int P1, int K, int C, int Z1, int COND, int H, int COUT,
    int hs_cs, float scale_eps, int mode, void* stream, int* launches) {
  ChainArgs a{chain_w, K, C, Z1, H, COUT, scale_eps, B, P1, nullptr, gc, gh,
              states, states, nullptr, nullptr, nullptr, 0, 0, 0, nullptr, mode,
              0, 0, 0, chain_hs, chain_hs ? hs_cs : 0};
  if (!chain_valid(a) || COND % 4 != 0 || N < 1) return FLOW_ERR_ARGS;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  ChainPlan plan;
  if (!chain_plan_for(B, a, 0, 0, 0, 0, CHAIN_WEIGHTS_AUTO, d, &plan))
    return FLOW_ERR_PLAN;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t state_bytes = (size_t)K * B * H * sizeof(float);
  err = cudaMemcpyAsync(states, states0, state_bytes, cudaMemcpyDeviceToDevice, st);
  if (err == cudaSuccess && P1 > 0)
    err = cudaMemcpyAsync(hist_a, hist0, (size_t)B * P1 * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  float* hist = hist_a;
  float* hist_next = hist_b;
  for (int t = 0; t < N; ++t) {
    const float* fixed = fixed_projs + (size_t)t * K * B * COND;
    err = sample_gates_enqueue(fixed, hist, w_p1_t, states, w_ih_t, w_hh_t,
                               b_ih, b_hh, proj, gc, gh, B, P1, K, Z1, COND,
                               H, 0, 0, GATES_PLAN_AUTO, mode, d, st,
                               &launches[0], &launches[2]);
    if (err != cudaSuccess) return (int)err;
    a.z_in = zs + (size_t)t * B * C;
    a.x_out = xs + (size_t)t * B * C;
    a.hist_in = hist;
    a.hist_out = hist_next;
    err = chain_enqueue(a, plan, d, st, &launches[1], true);
    if (err != cudaSuccess) return (int)err;
    float* tmp = hist;
    hist = hist_next;
    hist_next = tmp;
  }
  return (int)cudaGetLastError();
}

// The serial chain of one sampling frame, as a library of its own: the
// entry points that the wrapper ops/flow_kernels.py::sample_chain and the
// probe call to run, plan, time and trace it alone (frame_rev.cu and
// seq_rev.cu launch the same kernel, untraced).
//
// Replaces: the serial part of lets_face_it_tpu/ops/pallas_flow.py::_kernel
// and ::_seq_rev_kernel (the K reversed steps, given the gates that do not
// depend on them).
//
// What bounds it on an H100: latency, K dependent steps of three dependent
// products each (21 kFLOP a row and step); its 1.36 MB of weights are read
// once a launch. Design (sample_chain.cuh): the weights resident in a
// cluster's shared memory, each step on the block that holds it, the rows
// handed from block to block by st.async; where they do not fit, the hidden
// split (sample_chain_hsplit.cuh), or partly resident and partly streamed
// through a ring of shared-memory slots where no cluster splits H.

// This library alone compiles the probe's traced kernel (sample_chain.cuh).
#define SAMPLE_CHAIN_PROBE
#include "sample_chain.cuh"

// z [B, C], gc and gh [K, B, 3H], states_in [K, B, H] -> x [B, C],
// states_out [K, B, H] (may be states_in) and, when P1 > 0, hist_out
// [B, P1] from hist_in; weights [K, chain_step_floats] as ChainArgs says,
// hs_weights null or the hidden split's [K, hs_cs, chain_hs_rank_floats]
// (sample_chain_hsplit.cuh). bt, cs, m, slots: rows per tile, blocks per
// cluster, tiles per cluster, the ring's slots, 0 for the plan's; place:
// where the weights are held (sample_chain.cuh::ChainWeights, 0 for the
// plan's choice). trace: null, or [blocks, CHAIN_TRACE_SLOTS] device times of the
// first tile (sample_chain.cuh::ChainArgs; at mode FLOW_F32 only). mode:
// the matmul precision (flow_step.cuh::FlowPrecision). The launch is added to
// launches[1], and on the hidden split to launches[3] (launches[0] and [2]
// count gates, as in the other launchers).
extern "C" int sample_chain_launch(
    const float* z, const float* gc, const float* gh, const float* states_in,
    float* states_out, float* x_out, const float* hist_in, float* hist_out,
    const float* weights, const float* hs_weights, int B, int P1, int K, int C,
    int Z1, int H, int COUT, int hs_cs, float scale_eps, int bt, int cs, int m,
    int slots, int place, unsigned long long* trace, int mode, void* stream,
    int* launches) {
  ChainArgs a{weights, K, C, Z1, H, COUT, scale_eps, B, P1, z, gc, gh,
              states_in, states_out, x_out, hist_in, hist_out, 0, 0, 0, trace,
              mode, 0, 0, 0, hs_weights, hs_weights ? hs_cs : 0};
  if (!chain_valid(a)) return FLOW_ERR_ARGS;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  ChainPlan plan;
  if (!chain_plan_for(B, a, bt, cs, m, slots, place, d, &plan)) return FLOW_ERR_PLAN;
  return (int)chain_enqueue(a, plan, d, (cudaStream_t)stream, &launches[1]);
}

// The plan the launcher would use for B rows, the hidden split's weights
// laid out for a cluster of hs_cs (0: none), as out = {bt, cs, m, clusters,
// blocks, shared bytes a block, clusters the device holds at once, whether
// the weights are all resident, the placement (sample_chain.cuh::ChainPlace),
// the ring's slots and bytes a slot}; non-zero if there is none.
extern "C" int sample_chain_plan(int B, int K, int C, int Z1, int H, int COUT,
                                 int hs_cs, int bt, int cs, int m, int slots,
                                 int place, int* out) {
  static const float laid_out = 0.0f;   // a layout's stand-in: the plan reads none
  ChainArgs a{};
  a.B = B; a.K = K; a.C = C; a.Z1 = Z1; a.H = H; a.COUT = COUT;
  a.hs_weights = hs_cs ? &laid_out : nullptr;
  a.hs_cs = hs_cs;
  if (!chain_valid(a)) return FLOW_ERR_ARGS;
  FlowDevice d;
  cudaError_t err = flow_device(&d);
  if (err != cudaSuccess) return (int)err;
  ChainPlan plan;
  if (!chain_plan_for(B, a, bt, cs, m, slots, place, d, &plan)) return FLOW_ERR_PLAN;
  out[0] = plan.bt; out[1] = plan.cs; out[2] = plan.m; out[3] = plan.clusters;
  out[4] = plan.clusters * plan.cs; out[5] = plan.smem_bytes;
  out[6] = chain_resident_bt(plan, d);
  out[7] = plan.resident;
  out[8] = plan.place;
  out[9] = plan.nslots;
  out[10] = plan.slot_floats * 4;
  return 0;
}

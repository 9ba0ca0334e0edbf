"""The two kernels of a sampling frame (``sample_gates`` then
``sample_chain``, lets_face_it_tpu_torch/ops/flow_kernels.py) against the JAX
package's Pallas sampling kernels run in interpret mode on the CPU, and
against the port's plain whole-kernel versions.

On CPU tensors the wrappers run their plain versions; the CUDA kernels are
held against those on the card by ``test_cuda_kernels_match_plain``
(tests/test_torch_port_kernels.py) and by chip_smoke.py. The layout of the
chain's weights is checked here by reading it the way the kernel's lanes do.

Tolerance: atol 2e-4, rtol 1e-4 (the JAX kernel tests'): the split only
changes the order of summation of the GRU input product.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lets_face_it_tpu.model import flow as jflow
from lets_face_it_tpu.ops import pallas_flow
from lets_face_it_tpu_torch.hparams import load_hparams
from lets_face_it_tpu_torch.model import seqglow
from lets_face_it_tpu_torch.model.spec import FlowSpec as PortFlowSpec
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.sample.weights import seeded_random_model

from test_torch_port_common import (assert_close, jax_params, port_model,
                                    specs, tiny_hp)

HPARAMS = Path(__file__).resolve().parent.parent / "hparams"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.as_tensor(np.array(x))


def _setup(p1_dim):
    spec, pspec = specs(tiny_hp(p1_dim))
    params = jax_params(spec)
    model = port_model(params, pspec)
    jw = pallas_flow.prepare_sampling_weights(spec, params.flow)
    pw = fk.prepare_sampling_weights(pspec, model.flow)
    w = np.asarray(params.flow["cond_proj"]["w"])
    p1 = spec.cond.p1_face.out_dim
    w_p1_t = np.ascontiguousarray(w[:, :, :p1].transpose(0, 2, 1))
    return spec, pspec, params, jw, pw, w_p1_t


def _split_frame(pspec, pw, z, projs, states):
    """One frame as the card runs it: the gates (cond_projs given), then the
    chain; the wrappers take their plain versions on the CPU."""
    k, b = pspec.n_steps, z.shape[0]
    no_hist = torch.zeros(b, 0)
    _, gc, gh = fk.sample_gates(pspec, pw, torch.zeros(k, 0, pspec.cond.cond_dim),
                                projs, no_hist, states)
    x, new_states, new_hist = fk.sample_chain(pspec, pw, z, gc, gh, states)
    assert new_hist is None
    return x, new_states


def _split_sequence(pspec, pw, w_p1_t, zs, fixed, hist, states):
    """A whole sequence as the card runs it: per frame the gates from the
    history and the states, then the chain, which writes the next ones."""
    xs = []
    for i in range(zs.shape[0]):
        _, gc, gh = fk.sample_gates(pspec, pw, w_p1_t, fixed[i], hist, states)
        x, states, new_hist = fk.sample_chain(pspec, pw, zs[i], gc, gh, states,
                                              hist)
        hist = hist if new_hist is None else new_hist
        xs.append(x)
    return torch.stack(xs)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("p1_dim", [12, 0], ids=["own_face", "no_face"])
def test_gates_then_chain_match_frame_kernels(p1_dim, b):
    spec, pspec, params, jw, pw, _ = _setup(p1_dim)
    rng = np.random.default_rng(11 + b)
    z, cond = rand(rng, b, spec.channels), rand(rng, b, spec.cond.feature_dim)
    states = rand(rng, spec.n_steps, b, spec.hidden_channels, scale=0.3)
    jprojs = jflow._project_cond(params.flow, cond)
    jx, jst = pallas_flow.frame_rev_fused(spec, jw, z, jprojs, states,
                                          interpret=True)
    fk.sample_gates.launches = fk.sample_chain.launches = 0
    with torch.no_grad():
        projs = t(jprojs)
        x, st = _split_frame(pspec, pw, t(z), projs, t(states))
        px, pst = fk.frame_rev_fused_ref(pspec, pw, t(z), projs, t(states))
    assert fk.sample_gates.launches == fk.sample_chain.launches == 0   # CPU
    assert_close(x, jx)
    assert_close(st, jst)
    assert_close(x, px.numpy())
    assert_close(st, pst.numpy())


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("p1_dim", [12, 0], ids=["own_face", "no_face"])
def test_gates_then_chain_match_sequence_kernels(p1_dim, b):
    spec, pspec, _, jw, pw, w_p1_t = _setup(p1_dim)
    rng = np.random.default_rng(23 + b)
    n, k, cond = 5, spec.n_steps, spec.cond.cond_dim
    p1 = spec.cond.p1_face.out_dim
    zs = rand(rng, n, b, spec.channels)
    fixed = rand(rng, n, k, b, cond)
    states0 = rand(rng, k, b, spec.hidden_channels, scale=0.3)
    hist0 = rand(rng, b, p1)
    # the Pallas kernel takes an unused 8-wide dummy without an own face
    jhist = hist0 if p1 else np.zeros((b, 8), np.float32)
    jw_p1 = w_p1_t if p1 else np.zeros((k, 8, cond), np.float32)
    want = pallas_flow.sequence_rev_fused(spec, jw, jw_p1, zs, fixed, jhist,
                                          states0, interpret=True)
    with torch.no_grad():
        got = _split_sequence(pspec, pw, t(w_p1_t), t(zs), t(fixed), t(hist0),
                              t(states0))
        plain = fk.sequence_rev_fused_ref(pspec, pw, t(w_p1_t), t(zs), t(fixed),
                                          t(hist0), t(states0))
    assert got.shape == (n, b, spec.channels)
    assert_close(got, want)
    assert_close(got, plain.numpy())


def _read_as_the_chain_does(spec, w, k, z, h):
    """The chain's three products of step k, each output summed over the
    kernel's slices from ``w.chain`` read with the kernel's indexing
    (csrc/sample_chain.cuh): z[:Z1] @ w_ih_t[k][:Z1], h @ out_w_t[k],
    z @ W^-1[k], and the actnorm vectors."""
    c, z1, hd, cout = (spec.channels, spec.z1_dim, spec.hidden_channels,
                       spec.coupling_out_dim)
    g = 3 * hd
    s_gru, s_out, s_mix = fk._CHAIN_SLICES
    zq, hq, cq = -(-z1 // s_gru), -(-hd // s_out), -(-c // s_mix)
    blob = w.chain[k]
    o_wo = zq * s_gru * g
    o_ob = o_wo + hq * s_out * cout
    o_wi = o_ob + fk._round4(cout)
    o_ab = o_wi + cq * s_mix * c
    o_am = o_ab + fk._round4(c)
    # lane (part p, column u) reads blob[(m * G + u) * S + p] for row S*m + p
    zp = torch.cat([z, torch.zeros(s_gru * zq)])        # rows past Z1: weight 0
    wz = blob[:o_wo].reshape(zq, g, s_gru)
    gi = torch.einsum("mcp,mp->c", wz, zp[:s_gru * zq].reshape(zq, s_gru))
    hp = torch.cat([h, torch.zeros(s_out * hq - hd)])
    wo = blob[o_wo:o_ob].reshape(hq, cout, s_out)
    hout = torch.einsum("mcp,mp->c", wo, hp.reshape(hq, s_out))
    zc = torch.cat([z, torch.zeros(s_mix * cq - c)])
    wi = blob[o_wi:o_ab].reshape(cq, c, s_mix)
    mix = torch.einsum("mcp,mp->c", wi, zc.reshape(cq, s_mix))
    return (gi, hout, blob[o_ob:o_ob + cout], mix, blob[o_ab:o_ab + c],
            blob[o_am:o_am + c])


@pytest.mark.parametrize("config", ["tiny", "final_model"])
def test_chain_weights_follow_the_kernel_lanes(config, tmp_path):
    """``chain_weights`` lays each step out the way the chain kernel's lanes
    read it, with zero rows past the end (the tiny config's Z1 = 6 and
    C = 12 are not multiples of the slices)."""
    if config == "tiny":
        _, spec, _, _, w, _ = _setup(12)
    else:
        spec = PortFlowSpec.build(load_hparams(
            HPARAMS / "final_model.yaml", dataset_root=tmp_path))
        w = fk.prepare_sampling_weights(spec, seeded_random_model(spec, 3).flow)
    assert w.chain.shape == (spec.n_steps, fk.chain_step_bytes(spec) // 4)
    g = torch.Generator().manual_seed(5)
    z = torch.randn(spec.channels, generator=g)
    h = torch.randn(spec.hidden_channels, generator=g)
    for k in (0, spec.n_steps - 1):
        gi, hout, out_b, mix, an_bias, an_mul = _read_as_the_chain_does(spec, w, k,
                                                                        z, h)
        assert_close(gi, (z[:spec.z1_dim] @ w.w_ih_t[k, :spec.z1_dim]).numpy(),
                     atol=1e-5, rtol=1e-5)
        assert_close(hout, (h @ w.out_w_t[k]).numpy(), atol=1e-5, rtol=1e-5)
        assert_close(mix, (z @ w.w_inv[k]).numpy(), atol=1e-5, rtol=1e-5)
        for got, want in ((out_b, w.out_b[k]), (an_bias, w.an_bias[k]),
                          (an_mul, w.an_neg_logs_exp[k])):
            assert torch.equal(got, want)


@pytest.mark.parametrize("config", ["final_model", "no_face", "no_speech",
                                    "no_nll_trick"])
def test_envelope_holds_the_configs(config, tmp_path):
    spec = PortFlowSpec.build(load_hparams(
        HPARAMS / f"{config}.yaml", dataset_root=tmp_path))
    assert fk.fused_supported(spec) and fk.sampling_seq_supported(spec)
    assert fk.chain_smem_bytes(spec) <= fk.MAX_SMEM_BYTES


def test_envelope_refuses_chain_weights_that_overflow_a_cluster(tmp_path):
    """The chain's resident weights depend on C, Z1, H and Cout, not on the
    conditioning width: at H = 1024 one step's (586 KB) already overflows a
    block, so a cluster refuses to hold them; the chain then runs its
    hidden split (its streaming variant still fits when asked for), and the
    spec (inside the JAX kernels' envelope) still samples on the kernels."""
    hp = load_hparams(HPARAMS / "final_model.yaml",
                      dataset_root=tmp_path)
    hp.Glow["hidden_channels"] = 1024
    spec = PortFlowSpec.build(hp)
    assert fk.chain_step_bytes(spec) > fk.MAX_SMEM_BYTES
    assert not fk.chain_resident(spec)
    assert fk.chain_smem_bytes(spec, resident=False) <= fk.MAX_SMEM_BYTES
    assert fk.fused_supported(spec) and fk.sampling_seq_supported(spec)
    assert seqglow.sampling_path(spec) == "sequence"

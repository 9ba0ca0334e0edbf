"""The port's sampling-kernel module (lets_face_it_tpu_torch/ops/flow_kernels.py)
against the JAX package's Pallas kernels run in interpret mode on the CPU.

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA kernels
themselves are held against those plain versions on the card, by
``test_cuda_kernels_match_plain`` below (marked ``requires_cuda``) and by
chip_smoke.py.

Tolerance: atol 2e-4, rtol 1e-4 throughout. The 1x1 inverse differs in how it
is built (the port inverts P L U in float64 and rounds once; the JAX package
solves triangular systems in float32 and refines with one Newton-Schulz
step); both land within float32 rounding of the exact inverse, far inside
that tolerance (checked directly at atol 1e-5).
"""

import jax
import numpy as np
import pytest
import torch

from lets_face_it_tpu.model import flow as jflow
from lets_face_it_tpu.ops import pallas_flow
from lets_face_it_tpu_torch.model import flow as pflow
from lets_face_it_tpu_torch.model.spec import FlowSpec as PortFlowSpec
from lets_face_it_tpu_torch.ops import flow_kernels as fk

from test_torch_port_common import (assert_close, jax_params, port_hp,
                                    port_model, specs, tiny_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RNG = np.random.default_rng(7)


def rand(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.as_tensor(np.array(x))


def _setup(p1_dim=12, b=4):
    spec, pspec = specs(tiny_hp(p1_dim))
    params = jax_params(spec)
    model = port_model(params, pspec)
    jw = pallas_flow.prepare_sampling_weights(spec, params.flow)
    pw = fk.prepare_sampling_weights(pspec, model.flow)
    return spec, pspec, params, model, jw, pw


def test_prepared_weights_match_jax():
    """Folded coupling head, transposed GRU weights and the 1x1 inverse agree
    with the JAX package's preparation (w_ih_t there is padded to 8 rows)."""
    spec, pspec, _, _, jw, pw = _setup()
    rows = pw.w_ih_t.shape[1]
    np.testing.assert_array_equal(pw.w_ih_t.numpy(),
                                  np.asarray(jw.w_ih_t)[:, :rows])
    assert not np.asarray(jw.w_ih_t)[:, rows:].any()
    for name in ("w_hh_t", "b_ih", "b_hh", "an_bias"):
        np.testing.assert_array_equal(getattr(pw, name).numpy(),
                                      np.asarray(getattr(jw, name)))
    for name in ("out_w_t", "out_b", "an_neg_logs_exp"):
        assert_close(getattr(pw, name), getattr(jw, name), atol=1e-6, rtol=1e-6)
    assert_close(pw.w_inv, jw.w_inv, atol=1e-5, rtol=0)


@pytest.mark.parametrize("b", [1, 4])
def test_frame_rev_fused_matches_pallas_and_xla(b):
    spec, pspec, params, model, jw, pw = _setup()
    z, cond = rand(b, spec.channels), rand(b, spec.cond.feature_dim)
    states = rand(spec.n_steps, b, spec.hidden_channels, scale=0.3)
    jprojs = jflow._project_cond(params.flow, cond)
    jx, jst = pallas_flow.frame_rev_fused(spec, jw, z, jprojs, states,
                                          interpret=True)
    xx, _, xst = jflow.frame_rev(spec, params.flow, z, cond, states)
    with torch.no_grad():
        pprojs = pflow.project_cond(model.flow, t(cond))
        px, pst = fk.frame_rev_fused(pspec, pw, t(z), pprojs, t(states))
    assert fk.frame_rev_fused.launches == 0     # CPU: the plain version ran
    for want_x, want_st in ((jx, jst), (xx, xst)):
        assert_close(px, want_x)
        assert_close(pst, want_st)


@pytest.mark.parametrize("p1_dim", [12, 0], ids=["own_face", "no_face"])
def test_sequence_rev_fused_matches_pallas(p1_dim):
    spec, pspec, params, model, jw, pw = _setup(p1_dim)
    n, b, k = 6, 3, spec.n_steps
    cond, p1 = spec.cond.cond_dim, spec.cond.p1_face.out_dim
    zs = rand(n, b, spec.channels)
    fixed = rand(n, k, b, cond)
    states0 = rand(k, b, spec.hidden_channels, scale=0.3)
    w = np.asarray(params.flow["cond_proj"]["w"])
    if p1:
        hist0 = rand(b, p1)
        w_p1_t = np.ascontiguousarray(w[:, :, :p1].transpose(0, 2, 1))
        jhist, jw_p1 = hist0, w_p1_t
    else:   # the Pallas kernel takes an unused 8-wide dummy
        hist0 = np.zeros((b, 0), np.float32)
        w_p1_t = np.zeros((k, 0, cond), np.float32)
        jhist, jw_p1 = np.zeros((b, 8), np.float32), np.zeros((k, 8, cond), np.float32)
    want = pallas_flow.sequence_rev_fused(spec, jw, jw_p1, zs, fixed, jhist,
                                          states0, interpret=True)
    got = fk.sequence_rev_fused(pspec, pw, t(w_p1_t), t(zs), t(fixed), t(hist0),
                                t(states0))
    assert got.shape == (n, b, spec.channels)
    assert_close(got, want)


def test_frame_round_trip():
    """frame_fwd then the sampling inverse recovers the frame."""
    spec, pspec, _, model, _, pw = _setup()
    x, cond = t(rand(3, spec.channels)), t(rand(3, spec.cond.feature_dim))
    states = t(rand(spec.n_steps, 3, spec.hidden_channels, scale=0.3))
    with torch.no_grad():
        z, _, st_fwd = pflow.frame_fwd(pspec, model.flow, x, cond, states)
        x_back, st_rev = fk.frame_rev_fused(
            pspec, pw, z, pflow.project_cond(model.flow, cond), states)
    assert_close(x_back, x.numpy(), atol=1e-4, rtol=0)
    assert_close(st_rev, st_fwd.numpy(), atol=1e-6, rtol=0)


def test_envelopes_and_guards():
    spec_final = PortFlowSpec.build(port_hp(tiny_hp()))
    assert fk.sampling_seq_supported(spec_final)
    hp = tiny_hp()
    hp.Conditioning["p1_face"]["enc"] = "rnn"
    hp.Conditioning["p1_face"]["hidden_dim"] = 8
    rnn_face = PortFlowSpec.build(port_hp(hp))
    assert fk.fused_supported(rnn_face) and not fk.sampling_seq_supported(rnn_face)
    hp = tiny_hp()
    hp.Glow["rnn_type"] = "lstm"
    assert not fk.fused_supported(PortFlowSpec.build(port_hp(hp)))
    # the plain versions are for CPU tensors only; a reduced precision runs
    # as its plain twin at that mode, an unknown one is refused
    spec, pspec, _, _, _, pw = _setup()
    g = torch.Generator().manual_seed(0)
    z = torch.randn(2, spec.channels, generator=g)
    projs = torch.randn(spec.n_steps, 2, spec.cond.cond_dim, generator=g)
    states = 0.5 * torch.randn(spec.n_steps, 2, spec.hidden_channels, generator=g)
    x, st = fk.frame_rev_fused(pspec, pw, z, projs, states, precision="high")
    x_ref, st_ref = fk.frame_rev_fused_ref(pspec, pw, z, projs, states,
                                           fk.MODES["high"])
    assert torch.equal(x, x_ref) and torch.equal(st, st_ref)
    with pytest.raises(ValueError, match="precision"):
        fk.frame_rev_fused(pspec, pw, z, projs, states, precision="bf16")
    with pytest.raises(ValueError, match="device"):
        fk.frame_rev_fused(pspec, pw, z.to("meta"), projs, states)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_kernels_match_plain(cuda_device):
    """The sampling kernels against their plain versions on the card: both
    wrappers, and the two kernels of a frame alone (the gates with and
    without the own-face history, then the chain), at odd batches (partial
    row tiles and clusters)."""
    spec, pspec, _, model, _, _ = _setup()
    model = model.to(cuda_device)
    pw = fk.prepare_sampling_weights(pspec, model.flow)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    k, c = pspec.n_steps, pspec.channels
    cond, h, p1 = pspec.cond.cond_dim, pspec.hidden_channels, pspec.cond.p1_face.out_dim
    w_p1_t = model.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2).contiguous()

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    def close(got, want):
        for a, w in zip(got, want):
            if w is not None:
                assert_close(a.cpu(), w.cpu().numpy())

    def launched():
        return fk.sample_gates.launches, fk.sample_chain.launches

    for b in (5, 33):
        z, projs, states = randn(b, c), randn(k, b, cond), 0.3 * randn(k, b, h)
        hist = randn(b, p1)
        with torch.no_grad():
            before = launched()
            close(fk.frame_rev_fused(pspec, pw, z, projs, states),
                  fk.frame_rev_fused_ref(pspec, pw, z, projs, states))
            # the launchers report what they enqueued: gates and chain a frame
            assert launched() == (before[0] + 1, before[1] + 1)
            zs, fixed = randn(6, b, c), randn(6, k, b, cond)
            before = launched()
            close([fk.sequence_rev_fused(pspec, pw, w_p1_t, zs, fixed, hist, states)],
                  [fk.sequence_rev_fused_ref(pspec, pw, w_p1_t, zs, fixed, hist,
                                             states)])
            assert launched() == (before[0] + 6 * (2 if p1 else 1), before[1] + 6)
            for hist_b, w_p1_b in ((hist, w_p1_t), (hist[:, :0], w_p1_t[:, :0])):
                gates = fk.sample_gates_ref(pspec, pw, w_p1_b, projs, hist_b, states)
                close(fk.sample_gates(pspec, pw, w_p1_b, projs, hist_b, states), gates)
                _, gc, gh = gates
                hist_c = hist_b if hist_b.shape[-1] else None
                close(fk.sample_chain(pspec, pw, z, gc, gh, states, hist_c),
                      fk.sample_chain_ref(pspec, pw, z, gc, gh, states, hist_c))

"""The kernels' envelope against the JAX package's, and the padded lanes
that widen it (``lets_face_it_tpu_torch/ops/flow_kernels.py::kernel_spec``).

Over the whole grid of ``hparam_tuning_configs/large_hparam_search.py`` on
``hparams/final_model.yaml`` (K x H x cond x expression_dim), every spec the
JAX kernels take (``pallas_supported``, ``train_fused_spec_supported``) is
one the port's training and sampling kernels take. A spec whose coupling
halves are not multiples of 4 runs on padded lanes: the padded layouts
through the plain versions, unpadded, equal the plain versions at the
logical widths to 1e-6, forward and backward, with the logdet over the
logical lanes only; ``sequence_nll`` (values and gradients),
``sequence_sample`` (injected latents) and ``sequence_invert`` on such specs
against the JAX package (XLA on the CPU) at atol 2e-4 / rtol 1e-4, and
gradients at atol 2e-5 / rtol 1e-4 (the JAX kernel tests').
"""

import copy
import itertools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lets_face_it_tpu.hparams import load_hparams as jax_load_hparams
from lets_face_it_tpu.model import FlowSpec as JaxFlowSpec
from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu.ops import pallas_flow, pallas_train
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.ops import train_kernels as tk

from conftest import random_batch, tiny_hparams
from test_torch_port_common import assert_close, jax_params, port_model, specs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HPARAMS = Path(__file__).resolve().parent.parent / "hparams"
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)
# large_hparam_search.py's choices
KS, HS, CONDS = (4, 8, 16, 32), (16, 32, 64, 128, 256, 512), (64, 128, 256, 512, 1024)
EXPRESSION = range(5, 51)


def _grid_hp(base, k, h, cond, expression):
    hp = copy.deepcopy(base)
    hp.Glow["K"], hp.Glow["hidden_channels"] = k, h
    hp.Conditioning["cond_dim"] = cond
    hp.Data["expression_dim"] = expression
    c = expression + hp.Data["jaw_dim"] + hp.Data["neck_dim"]
    hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = c
    return hp


@pytest.mark.parametrize("k", KS)
def test_port_envelopes_cover_the_jax_envelope_over_the_search_grid(k, tmp_path):
    base = jax_load_hparams(HPARAMS / "final_model.yaml", dataset_root=tmp_path)
    inside = 0
    for h, cond, e in itertools.product(HS, CONDS, EXPRESSION):
        jspec, pspec = specs(_grid_hp(base, k, h, cond, e))
        jax_train = pallas_train.train_fused_spec_supported(jspec)
        jax_sample = pallas_flow.pallas_supported(jspec)
        assert fk.jax_envelope(pspec) == jax_sample == jax_train
        if not jax_sample:
            continue
        inside += 1
        assert tk.train_supported(pspec), (k, h, cond, e)
        assert tk.train_smem_bytes(pspec) <= fk.MAX_SMEM_BYTES
        assert fk.fused_supported(pspec), (k, h, cond, e)
        # the JAX kernel also wants a 'none' window a multiple of 8 wide
        assert fk.sampling_seq_supported(pspec)
        assert pallas_flow.sampling_seq_supported(jspec) <= fk.sampling_seq_supported(pspec)
        assert pseqglow.training_path(pspec) == "kernels"
        assert pseqglow.sampling_path(pspec) == "sequence"
    # C even (23 of the 46 expression widths) x H in {128, 256, 512} x cond >= 128
    assert inside == 23 * 3 * 4


def test_training_kernels_fit_the_whole_search_grid(tmp_path):
    """The serial training kernels' one-row tile on their launchers' plans
    peaks at H = 128, K = 32 (54,880 B of the 232,448 a block may have: the
    walk's; from H = 256 both kernels take the hidden split, whose blocks
    hold a slice of the hidden units: 26,992 at H = 512, K = 32, where the
    walks' would be 206,944); a change to their layout that pushed a spec of
    the grid out would fail here."""
    base = jax_load_hparams(HPARAMS / "final_model.yaml", dataset_root=tmp_path)
    peak = max(tk.train_smem_bytes(specs(_grid_hp(base, k, h, cond, 50))[1])
               for k, h, cond in itertools.product(KS, (128, 256, 512), CONDS[1:]))
    assert peak == 54_880 <= fk.MAX_SMEM_BYTES
    spec = specs(_grid_hp(base, 32, 512, 512, 50))[1]
    assert tk.train_smem_bytes(spec, "hsplit") == 26_992
    assert tk.train_smem_bytes(spec, "walk") == 206_944


@pytest.mark.parametrize("c, padded", [(50, 56), (52, 56), (54, 56), (56, 56),
                                       (12, 16), (46, 48)])
def test_kernel_spec_pads_each_half_to_a_multiple_of_4(c, padded, tmp_path):
    base = jax_load_hparams(HPARAMS / "final_model.yaml", dataset_root=tmp_path)
    _, spec = specs(_grid_hp(base, 4, 128, 512, c - 6))
    ks = fk.kernel_spec(spec)
    assert ks.channels == padded and ks.z1_dim % 4 == 0
    assert fk.kernel_spec(ks) is ks
    assert (ks is spec) == (c == padded)
    idx = fk.lane_index(spec)
    assert idx.tolist() == (list(range(c // 2))
                            + list(range(padded // 2, padded // 2 + c // 2)))
    p1 = ks.cond.p1_face
    assert p1.out_dim == padded * p1.history
    assert ks.coupling_out_dim == padded


def wide_hp(c=54, h=128, k=2, cond=128, p1_enc="none"):
    """conftest's tiny config at widths of the JAX kernels' envelope: C = c
    (expression c - 6, jaw 3, neck 3), hidden h, K = k, cond."""
    hp = tiny_hparams()
    hp.Data["expression_dim"] = c - 6
    hp.Glow["K"], hp.Glow["hidden_channels"] = k, h
    hp.Conditioning["cond_dim"] = cond
    hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = c
    hp.Conditioning["p1_face"]["enc"] = p1_enc
    return hp


def _unpad_weights(spec, w):
    """A prepared set in the kernel spec's lanes back at the logical
    widths (the inverse of ``fk.pad_weight``)."""
    ks = fk.kernel_spec(spec)
    idx = fk.lane_index(spec)
    rows = torch.cat([torch.arange(spec.z1_dim),
                      ks.z1_dim + torch.arange(spec.cond.cond_dim)])
    out = {}
    for name, v in w._asdict().items():
        if name in ("w", "w_inv"):
            v = v.index_select(1, idx).index_select(2, idx)
        elif name in ("an_bias", "an_scale", "an_neg_logs_exp", "out_b"):
            v = v.index_select(1, idx)
        elif name == "out_w_t":
            v = v.index_select(2, idx)
        elif name == "w_ih_t":
            v = v.index_select(1, rows)
        out[name] = v.contiguous() if torch.is_tensor(v) else v
    return out


def _model(spec, pspec, seed=0):
    return port_model(jax_params(spec, seed=seed), pspec)


@pytest.mark.parametrize("c", [50, 54])
def test_padded_weights_carry_the_logical_ones_exactly(c):
    spec, pspec = specs(wide_hp(c))
    model = _model(spec, pspec)
    ks = fk.kernel_spec(pspec)
    sw = fk.prepare_sampling_weights(pspec, model.flow)
    assert sw.w_inv.shape == (ks.n_steps, ks.channels, ks.channels)
    logical = _unpad_weights(pspec, sw)
    pad = torch.ones(ks.channels, dtype=torch.bool)
    pad[fk.lane_index(pspec)] = False
    for name in ("w_ih_t", "out_w_t", "out_b", "an_bias", "w_inv", "an_neg_logs_exp"):
        assert torch.equal(fk.pad_weight(pspec, name, logical[name]), getattr(sw, name))
    assert torch.equal(sw.w_inv[:, pad][:, :, pad],
                       torch.eye(int(pad.sum())).expand(ks.n_steps, -1, -1))
    assert torch.equal(sw.an_neg_logs_exp[:, pad], torch.ones(ks.n_steps, int(pad.sum())))
    tw = tk.prepare_train_weights(pspec, model.flow)
    again = _unpad_weights(pspec, tw)
    for name in ("w", "an_scale", "w_ih_t", "out_w_t"):
        assert torch.equal(fk.pad_weight(pspec, name, again[name]), getattr(tw, name))


def _sampling_inputs(spec, b, n, seed):
    rng = np.random.default_rng(seed)
    k, c, h, cond = spec.n_steps, spec.channels, spec.hidden_channels, spec.cond.cond_dim
    p1 = spec.cond.p1_face.out_dim
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return (f(n, b, c), f(n, k, b, cond) * 0.3, f(b, p1), f(k, p1, cond) * 0.05,
            f(k, b, h) * 0.5)


@pytest.mark.parametrize("c", [50, 54])
def test_padded_sampling_plain_versions_equal_the_logical_ones(c):
    """The frame's and the sequence's plain versions on the padded layout
    (weights, z, the own-face window), unpadded, against the same plain
    versions at the logical widths: 1e-6 (absolute and relative: the sums
    run in another order); the padded lanes come out zero."""
    spec, pspec = specs(wide_hp(c))
    ks = fk.kernel_spec(pspec)
    model = _model(spec, pspec, seed=1)
    sw = fk.prepare_sampling_weights(pspec, model.flow)
    lw = fk.SamplingWeights(**_unpad_weights(pspec, sw))
    zs, fixed, hist, w_p1_t, states = _sampling_inputs(pspec, b=3, n=4, seed=2)
    pad = torch.ones(ks.channels, dtype=torch.bool)
    pad[fk.lane_index(pspec)] = False

    x_p, st_p = fk.frame_rev_fused_ref(ks, sw, fk.pad_lanes(pspec, zs[0]),
                                       fixed[0], states)
    x_l, st_l = fk.frame_rev_fused_ref(pspec, lw, zs[0], fixed[0], states)
    assert torch.equal(x_p[:, pad], torch.zeros_like(x_p[:, pad]))
    assert_close(fk.unpad_lanes(pspec, x_p), x_l.numpy(), atol=1e-6, rtol=0)
    assert_close(st_p, st_l.numpy(), atol=1e-6, rtol=0)
    # the wrapper pads and unpads itself
    assert_close(fk.frame_rev_fused(pspec, sw, zs[0], fixed[0], states)[0],
                 x_l.numpy(), atol=1e-6, rtol=0)

    xs_p = fk.sequence_rev_fused_ref(ks, sw, fk.pad_history(pspec, w_p1_t, 1),
                                     fk.pad_lanes(pspec, zs), fixed,
                                     fk.pad_history(pspec, hist, 1), states)
    xs_l = fk.sequence_rev_fused_ref(pspec, lw, w_p1_t, zs, fixed, hist, states)
    assert torch.equal(xs_p[..., pad], torch.zeros_like(xs_p[..., pad]))
    assert_close(fk.unpad_lanes(pspec, xs_p), xs_l.numpy(), atol=1e-6, rtol=1e-6)
    assert_close(fk.sequence_rev_fused(pspec, sw, w_p1_t, zs, fixed, hist, states),
                 xs_l.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("c", [50, 54])
def test_padded_training_plain_versions_equal_the_logical_ones(c):
    """``seq_fwd_ref`` and ``seq_bwd_ref`` on the padded layout against the
    logical widths: every output at 1e-6 after unpadding; the padded lanes'
    z are zero and their scales sigmoid(2) (so the logdet must skip them),
    and with zero cotangents in the padded lanes the backward's padded
    cotangents are zero."""
    spec, pspec = specs(wide_hp(c))
    ks = fk.kernel_spec(pspec)
    model = _model(spec, pspec, seed=3)
    tw = tk.prepare_train_weights(pspec, model.flow)
    tw = tk.TrainWeights(*(v.detach() for v in tw))
    lw = tk.TrainWeights(**_unpad_weights(pspec, tw))
    n, b, half, half_p = 3, 2, c // 2, ks.channels // 2
    rng = np.random.default_rng(4)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    xs, cond, states0 = f(n, b, c), f(n, 2, b, 128) * 0.3, f(2, b, 128) * 0.5
    fwd_p = tk.seq_fwd_ref(ks, tw, fk.pad_lanes(pspec, xs), cond, states0)
    fwd_l = tk.seq_fwd_ref(pspec, lw, xs, cond, states0)
    pad = torch.ones(ks.channels, dtype=torch.bool)
    pad[fk.lane_index(pspec)] = False
    assert torch.equal(fwd_p[0][..., pad], torch.zeros_like(fwd_p[0][..., pad]))
    assert torch.allclose(fwd_p[1][..., half:], torch.sigmoid(torch.tensor(2.0)))
    assert_close(fk.unpad_lanes(pspec, fwd_p[0]), fwd_l[0].numpy(), atol=1e-6, rtol=0)
    assert_close(fwd_p[1][..., :half], fwd_l[1].numpy(), atol=1e-6, rtol=0)
    assert_close(fk.unpad_lanes(pspec, fwd_p[2]), fwd_l[2].numpy(), atol=1e-6, rtol=0)
    for got, want in zip(fwd_p[3:], fwd_l[3:]):
        assert_close(got, want.numpy(), atol=1e-6, rtol=0)

    dz, dsc, dst = f(n, b, c), f(n, 2, b, half), f(2, b, 128)
    _, _, zs_p, st_p, gc_p = fwd_p
    _, _, zs_l, st_l, gc_l = fwd_l
    hprev_p = torch.cat([states0[None], st_p[:-1]])
    hprev_l = torch.cat([states0[None], st_l[:-1]])
    dsc_p = torch.nn.functional.pad(dsc, (0, half_p - half))
    bwd_p = tk.seq_bwd_ref(ks, tw, gc_p, zs_p, hprev_p, fk.pad_lanes(pspec, dz),
                           dsc_p, dst)
    bwd_l = tk.seq_bwd_ref(pspec, lw, gc_l, zs_l, hprev_l, dz, dsc, dst)
    dx_p, dstates_p, dgi_p, dghn_p, dhout_p, dzb_p = bwd_p
    for lanes in (dx_p, dzb_p, dhout_p):
        assert torch.equal(lanes[..., pad], torch.zeros_like(lanes[..., pad]))
    for got, want in ((fk.unpad_lanes(pspec, dx_p), bwd_l[0]), (dstates_p, bwd_l[1]),
                      (dgi_p, bwd_l[2]), (dghn_p, bwd_l[3]),
                      (fk.unpad_lanes(pspec, dhout_p), bwd_l[4]),
                      (fk.unpad_lanes(pspec, dzb_p), bwd_l[5])):
        assert_close(got, want.numpy(), atol=1e-6, rtol=0)


CASES = {"c54": dict(c=54), "c50": dict(c=50),
         "h256_k16": dict(c=54, h=256, k=16)}
# The flow weights' perturbation (``jax_params``): over 16 steps one of
# 0.05 makes the random flow diverge (|x| in the hundreds), and float32
# rounding then differs by more than the limits between any two orders of
# summation.
SCALES = {"c54": 0.05, "c50": 0.05, "h256_k16": 0.01}


def _port_leaf(model, path):
    for key in path:
        model = model[key]
    return model


def _data(hp, spec, b, seq_len, seed):
    data = random_batch(hp, batch_size=b, seq_len=seq_len, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for name in ("p1_face", "p2_face"):
        data[name] = rng.standard_normal((b, seq_len, spec.channels)).astype(np.float32)
    return data


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_nll_on_padded_lanes_matches_jax(case):
    """Loss, [N, B] losses and every trained parameter's gradient through
    the training kernels' plain versions on padded lanes, against the JAX
    package's XLA path."""
    hp = wide_hp(**CASES[case])
    spec, pspec = specs(hp)
    assert fk.kernel_spec(pspec).channels == 56
    assert pseqglow.training_path(pspec) == "kernels"
    params = jax_params(spec, seed=5, scale=SCALES[case])
    data = _data(hp, spec, b=2, seq_len=hp.Conditioning["p2_face"]["history"] + 3,
                 seed=6)

    def jloss(p):
        _, loss, losses = jseqglow.sequence_nll(spec, p, data, use_fused=False)
        return loss, losses

    (jl, jlosses), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = port_model(params, pspec)
    _, loss, losses = pseqglow.sequence_nll(
        pspec, model, {k: torch.as_tensor(v) for k, v in data.items()})
    loss.backward()
    assert_close(loss, jl)
    assert_close(losses, jlosses)
    for tree, port_tree in ((jgrads.encoder, model.encoder), (jgrads.flow, model.flow)):
        for jpath, g in jax.tree_util.tree_flatten_with_path(tree)[0]:
            leaf = _port_leaf(port_tree, [p.key for p in jpath])
            if not leaf.requires_grad:
                continue
            got = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            assert_close(got, g, **GRAD_TOL)


@pytest.mark.parametrize("case, p1_enc, path", [
    ("c54", "none", "sequence"), ("c50", "none", "sequence"),
    ("h256_k16", "none", "sequence"), ("c54", "rnn", "frame")])
def test_sequence_sample_on_padded_lanes_matches_jax(case, p1_enc, path):
    """Generation from injected latents through the sampling kernels' plain
    versions on padded lanes (the whole-sequence one with its own-face
    window of padded frames, or the per-frame one) against the JAX
    package."""
    hp = wide_hp(**CASES[case], p1_enc=p1_enc)
    spec, pspec = specs(hp)
    assert pseqglow.sampling_path(pspec) == path
    params = jax_params(spec, seed=7, scale=SCALES[case])
    seq_len, b = hp.Conditioning["p2_face"]["history"] + 4, 2
    data = _data(hp, spec, b, seq_len, seed=8)
    n = seq_len - spec.cond.longest_history
    z_seq = np.random.default_rng(9).standard_normal(
        (n, b, spec.channels)).astype(np.float32)
    want = jseqglow.sequence_sample(spec, params, data, seq_len,
                                    rng=jax.random.PRNGKey(0), z_seq=z_seq)
    got = pseqglow.sequence_sample(pspec, port_model(params, pspec),
                                   {k: torch.as_tensor(v) for k, v in data.items()},
                                   seq_len, z_seq=torch.as_tensor(z_seq))
    assert got.shape == (b, n, spec.channels)
    assert_close(got, want)


def test_sequence_invert_on_padded_lanes_matches_the_plain_route():
    """The per-frame kernel's route (its plain version on the CPU, padded
    lanes, the logdet recovered from the states over the logical lanes)
    against the plain flow."""
    hp = wide_hp(54)
    spec, pspec = specs(hp)
    model = _model(spec, pspec, seed=10)
    data = {k: torch.as_tensor(v) for k, v in
            _data(hp, spec, 2, hp.Conditioning["p2_face"]["history"] + 3, 11).items()}
    z_seq, _, _ = pseqglow.sequence_nll(pspec, model, data)
    with torch.no_grad():
        x_k, loss_k = pseqglow.sequence_invert(pspec, model, z_seq, data, route="kernel")
        x_p, loss_p = pseqglow.sequence_invert(pspec, model, z_seq, data, route="plain")
    assert_close(x_k, x_p.numpy())
    assert_close(loss_k, loss_p.numpy())


def test_a_jax_envelope_spec_at_h1024_trains_on_the_kernels(tmp_path):
    """At H = 1024 (final_model's widths otherwise) the serial training
    kernels run their hidden split, whose one-row blocks fit; its sampling
    runs the chain's hidden split too."""
    hp = jax_load_hparams(HPARAMS / "final_model.yaml", dataset_root=tmp_path)
    hp.Glow["hidden_channels"] = 1024
    _, pspec = specs(hp)
    assert tk.train_supported(pspec) and fk.jax_envelope(pspec)
    assert pseqglow.training_path(pspec) == "kernels"
    assert tk.seq_fwd_plan_name(pspec) == tk.seq_bwd_plan_name(pspec) == "hsplit"
    assert tk.train_smem_bytes(pspec) <= fk.MAX_SMEM_BYTES
    assert pseqglow.sampling_path(pspec) == "sequence"
    assert not fk.chain_resident(pspec)


def test_a_jax_envelope_spec_the_kernels_cannot_take_raises(tmp_path, monkeypatch):
    """The first H of the JAX kernels' envelope (multiples of 128) that the
    port's kernels refuse is H = 8,320, past the hidden splits' ceiling (3H
    / 16 above 4 columns a consumer thread), for training and sampling
    alike (tests/test_torch_sample_hsplit.py: every H below it takes both).
    Every path a card would run raises rather than run the plain one:
    training, generation, the inversion's route and the streaming
    generator, on a "cuda" device; ``flow.frame_rev`` is never called."""
    from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator

    hp = jax_load_hparams(HPARAMS / "final_model.yaml", dataset_root=tmp_path)
    hp.Glow["K"], hp.Glow["hidden_channels"] = 4, 8320
    _, pspec = specs(hp)
    assert fk.jax_envelope(pspec) and tk.hsplit_cluster(pspec) is None
    assert not tk.train_supported(pspec) and not fk.fused_supported(pspec)
    assert fk.chain_placement(pspec) is None

    def plain(*args, **kwargs):
        raise AssertionError("the plain sampling path ran")

    monkeypatch.setattr(pseqglow.flow, "frame_rev", plain)
    for refused in (lambda: pseqglow.training_path(pspec),
                    lambda: pseqglow.sampling_path(pspec),
                    lambda: pseqglow.inversion_route(pspec, "cuda"),
                    lambda: StreamingGenerator(pspec, None, device="cuda")):
        with pytest.raises(ValueError, match="JAX kernels' envelope"):
            refused()
    # the CPU's plain route stays: the dev box runs the plain versions
    assert pseqglow.inversion_route(pspec, "cpu") == "plain"

"""Per-op parity of the port's core ops, recurrent cells, encoders and flow
helpers with the JAX package (lets_face_it_tpu/core/ops.py, core/rnn.py,
model/encoders.py, model/flow.py), on the same numpy inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.core import ops as jops
from lets_face_it_tpu.core import rnn as jrnn
from lets_face_it_tpu.model import encoders as jenc
from lets_face_it_tpu.model import flow as jflow
from lets_face_it_tpu.model.spec import EncSpec
from lets_face_it_tpu_torch.core import ops as pops
from lets_face_it_tpu_torch.core import rnn as prnn
from lets_face_it_tpu_torch.model import encoders as penc
from lets_face_it_tpu_torch.model import flow as pflow
from lets_face_it_tpu_torch.model.spec import EncSpec as PortEncSpec

from test_torch_port_common import (assert_close, jax_params, numpy_tree,
                                    port_model, specs, tiny_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RNG = np.random.default_rng(0)


def rand(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.as_tensor(np.array(x))


def tt(tree):
    return jax.tree.map(lambda x: t(np.asarray(x)), tree)


def perturbed_invconv(c=12):
    p = jops.init_invconv_lu(jax.random.PRNGKey(1), c)
    p["log_s"] = p["log_s"] + 0.3 * jax.random.normal(jax.random.PRNGKey(2), (c,))
    p["l"] = p["l"] + 0.05 * jnp.tril(jax.random.normal(jax.random.PRNGKey(3), (c, c)), -1)
    p["u"] = p["u"] + 0.05 * jnp.triu(jax.random.normal(jax.random.PRNGKey(4), (c, c)), 1)
    return p


@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_actnorm(direction):
    params = {"bias": rand(12), "logs": rand(12, scale=0.3)}
    x, ld = rand(5, 12), rand(5)
    jf = getattr(jops, f"actnorm_{direction}")
    pf = getattr(pops, f"actnorm_{direction}")
    jz, jld = jf(params, x, ld)
    pz, pld = pf(tt(params), t(x), t(ld))
    assert_close(pz, jz)
    assert_close(pld, jld)


@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_invconv(direction):
    params = perturbed_invconv()
    x, ld = rand(5, 12), rand(5)
    jz, jld = getattr(jops, f"invconv_{direction}")(params, x, ld)
    pz, pld = getattr(pops, f"invconv_{direction}")(tt(params), t(x), t(ld))
    assert_close(pz, jz)
    assert_close(pld, jld)


def test_lu_factors():
    params = perturbed_invconv()
    for got, want in zip(pops.lu_factors(tt(params)), jops._lu_factors(params)):
        assert_close(got, want, atol=1e-6)


@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_permute(direction):
    perm = np.random.default_rng(1).permutation(12)
    params = {"perm": perm, "inv": np.argsort(perm)}
    x, ld = rand(5, 12), rand(5)
    jz, _ = getattr(jops, f"permute_{direction}")(params, x, ld)
    pz, _ = getattr(pops, f"permute_{direction}")(tt(params), t(x), t(ld))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))


def test_linear_and_linear_zeros():
    params = {"w": rand(7, 12), "b": rand(7), "logs": rand(7, scale=0.2)}
    x = rand(5, 12)
    assert_close(pops.linear(tt(params), t(x)), jops.linear(params, x))
    assert_close(pops.linear_zeros(tt(params), t(x)),
                 jops.linear_zeros(params, x))


def test_split_cat_and_scale():
    h = rand(5, 12)
    for got, want in zip(pops.split_half(t(h)), jops.split_half(h)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    shift, scale_raw = pops.split_cross(t(h))
    np.testing.assert_array_equal(shift.numpy(), h[:, 0::2])
    np.testing.assert_array_equal(scale_raw.numpy(), h[:, 1::2])
    np.testing.assert_array_equal(pops.cat_half(t(h[:, :5]), t(h[:, 5:])).numpy(), h)
    raw = rand(5, 6, scale=6.0)
    assert_close(pops.affine_scale(t(raw), 0.05), jops.affine_scale(raw, 0.05),
                 atol=1e-6)
    assert_close(pops.gaussian_logp(t(h)), jops.gaussian_logp(h))


def test_gru_cell():
    params = jrnn.init_gru_cell(jax.random.PRNGKey(0), 9, 6)
    x, h = rand(4, 9), rand(4, 6)
    assert_close(prnn.gru_cell(tt(params), t(x), t(h)),
                 jrnn.gru_cell(params, x, h))


def test_lstm_cell():
    params = jrnn.init_lstm_cell(jax.random.PRNGKey(0), 9, 6)
    x, h, c = rand(4, 9), rand(4, 6), rand(4, 6)
    for got, want in zip(prnn.lstm_cell(tt(params), t(x), (t(h), t(c))),
                         jrnn.lstm_cell(params, x, (h, c))):
        assert_close(got, want)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan(cell):
    params = getattr(jrnn, f"init_{cell}_cell")(jax.random.PRNGKey(5), 9, 6)
    xs = rand(3, 7, 9)
    jys, jlast = getattr(jrnn, f"{cell}_scan")(params, xs)
    pys, plast = getattr(prnn, f"{cell}_scan")(tt(params), t(xs))
    assert_close(pys, jys)
    for got, want in zip(jax.tree.leaves(plast),
                         jax.tree.leaves(jlast)):
        assert_close(got, want)


def test_gru_cell_matches_torch_module():
    """The explicit cell computes torch.nn.GRUCell (reference checkpoints
    load verbatim)."""
    cell = torch.nn.GRUCell(9, 6)
    params = {"w_ih": cell.weight_ih, "w_hh": cell.weight_hh,
              "b_ih": cell.bias_ih, "b_hh": cell.bias_hh}
    x, h = t(rand(4, 9)), t(rand(4, 6))
    with torch.no_grad():
        assert_close(prnn.gru_cell(params, x, h), cell(x, h).numpy(), atol=1e-6)


@pytest.mark.parametrize("enc", ["rnn", "lstm", "mlp", "cnn", "none"])
def test_encode_windows(enc):
    jspec = EncSpec.build(5, {"enc": enc, "history": 4, "hidden_dim": 6,
                              "kernel_size": 3})
    pspec = PortEncSpec(**dataclasses.asdict(jspec))
    params = jenc.init_modality_encoder(jax.random.PRNGKey(2), jspec)
    windows = rand(2, 3, 4, 5)
    want = jenc.encode_windows(jspec, params, windows)
    got = penc.encode_windows(pspec, tt(params), t(windows))
    assert got.shape == (2, 3, jspec.out_dim)
    assert_close(got, want)


@pytest.mark.parametrize("kind", ["own_face", "other"])
def test_windows_edges(kind):
    x = rand(2, 10, 3)
    times = np.arange(4, 10)
    want = getattr(jenc, f"{kind}_windows")(x, jnp.asarray(times), 4)
    got = getattr(penc, f"{kind}_windows")(t(x), t(times), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fixed_conditioning_and_p1_single():
    hp = tiny_hp()
    spec, pspec = specs(hp)
    params = jax_params(spec)
    model = port_model(params, pspec)
    from conftest import random_batch

    batch = random_batch(hp, batch_size=2, seq_len=10)
    times = np.arange(4, 10)
    want = jenc.encode_fixed_conditioning(spec.cond, params.encoder, batch,
                                          jnp.asarray(times))
    with torch.no_grad():
        got = penc.encode_fixed_conditioning(
            pspec.cond, model.encoder, {k: t(v) for k, v in batch.items()},
            t(times))
        assert_close(got, want)
        hist = batch["p1_face"][:, :3]
        assert_close(penc.encode_p1_face_single(pspec.cond, model.encoder, t(hist)),
                     jenc.encode_p1_face_single(spec.cond, params.encoder, hist))


def test_project_cond_and_split():
    spec, pspec = specs(tiny_hp())
    params = jax_params(spec)
    model = port_model(params, pspec)
    cond = rand(3, spec.cond.feature_dim)
    p1 = spec.cond.p1_face.out_dim
    with torch.no_grad():
        assert_close(pflow.project_cond(model.flow, t(cond)),
                     jflow._project_cond(params.flow, cond))
        fixed_all = rand(3, 5, spec.cond.feature_dim - p1)
        got_fixed, got_w = pflow.project_cond_split(model.flow, p1, t(fixed_all))
    want_fixed, want_w = jflow.project_cond_split(params.flow, p1, fixed_all)
    assert_close(got_fixed, want_fixed)
    np.testing.assert_array_equal(got_w.detach().numpy(), np.asarray(want_w))


@pytest.mark.parametrize("direction", ["fwd", "rev"])
def test_frame_fwd_rev(direction):
    """One frame through all K steps, with non-zero GRU states."""
    spec, pspec = specs(tiny_hp())
    params = jax_params(spec)
    model = port_model(params, pspec)
    x, cond = rand(3, spec.channels), rand(3, spec.cond.feature_dim)
    states = rand(spec.n_steps, 3, spec.hidden_channels, scale=0.3)
    jx, jld, jst = getattr(jflow, f"frame_{direction}")(spec, params.flow, x,
                                                         cond, states)
    with torch.no_grad():
        px, pld, pst = getattr(pflow, f"frame_{direction}")(
            pspec, model.flow, t(x), t(cond), t(states))
    assert_close(px, jx)
    assert_close(pld, jld)
    assert_close(pst, jst)


def test_frame_rev_lstm_additive_shuffle():
    """Outside the kernels' envelope the plain flow path serves: LSTM
    couplings, additive coupling, shuffle permutation."""
    hp = tiny_hp()
    hp.Glow.update(rnn_type="lstm", flow_coupling="additive",
                   flow_permutation="shuffle")
    spec, pspec = specs(hp)
    params = jax_params(spec)
    model = port_model(params, pspec)
    z, cond = rand(2, spec.channels), rand(2, spec.cond.feature_dim)
    states = (rand(spec.n_steps, 2, spec.hidden_channels, scale=0.3),
              rand(spec.n_steps, 2, spec.hidden_channels, scale=0.3))
    jx, _, (jh, jc) = jflow.frame_rev(spec, params.flow, z, cond, states)
    with torch.no_grad():
        px, _, (ph, pc) = pflow.frame_rev(pspec, model.flow, t(z), t(cond),
                                          (t(states[0]), t(states[1])))
    assert_close(px, jx)
    assert_close(ph, jh)
    assert_close(pc, jc)
    assert numpy_tree(params.flow)["perm"]["perm"].dtype.kind == "i"

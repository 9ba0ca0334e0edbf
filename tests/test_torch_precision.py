"""The port's matmul precision modes ("highest", "high", "medium") on the CPU.

* The mapping of torch's ambient setting (``ambient_matmul_precision``),
  as tests/test_pallas_train.py:236 maps JAX's, and the context manager that
  the trainer's ``precision`` switch runs under.
* The rounding helpers against independent numpy ones: bf16 bit for bit
  against ``ml_dtypes.bfloat16``, TF32 against ``cvt.rna.tf32.f32``'s rule on
  the bit pattern.
* Each kernel's plain version at "high" and "medium" against a float64
  emulation of the JAX kernel that rounds the operands at exactly the
  products the JAX kernels mark with ``precision=`` (pallas_flow.py
  ``_kernel`` and ``_seq_rev_kernel``; pallas_train.py ``_fwd_kernel``,
  ``_bwd_kernel`` and the weight-gradient einsums of ``_flow_seq_bwd``):
  frame_rev, seq_rev, the training forward, its backward and the gradients
  through the autograd Function. JAX on the CPU ignores DEFAULT (the
  interpret-mode kernel returns the float32 result), so it cannot be the
  oracle of the reduced modes; the emulation is written here from the JAX
  kernels' text, in numpy, with its own rounding.
* "highest" against the JAX package (interpret mode); "medium" against the
  JAX package's float32 within a bf16-sized bound, which catches rounding
  left out at a product; an unknown mode refused.

Limits against the emulation, in steps of the mode's grid (2^-10 relative
for TF32, 2^-7 for bf16). The plain versions sum in float32, the emulation
in float64, so an activation that lands within a float32 rounding of a
rounding boundary can round the other way and move by one step; through the
K steps (and the frames of a sequence) such a flip spreads, but it is rare:
the largest |difference| is held to ``EMU_MAX_STEPS`` of the output's
largest |value|, and the root mean square of the differences to
``EMU_RMS_STEPS`` of the output's root mean square. A rounding left out at
one product moves every element: a copy of the plain versions without the
coupling head's rounding read 0.15-0.22 steps RMS (TF32 and bf16), where
these versions read at most 0.064 (TF32) and 1.4e-05 (bf16), and at most
0.21 steps in the largest difference.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lets_face_it_tpu.ops import pallas_flow, pallas_train
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.ops import train_kernels as tk
from lets_face_it_tpu_torch.utils.precision import (matmul_precision,
                                                    training_precision)

from test_torch_port_common import (ATOL, RTOL, assert_close, jax_params,
                                    port_model, specs, tiny_hp, train_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# One step of each reduced mode's grid (relative), and the steps allowed.
GRID = {"high": 2.0 ** -10, "medium": 2.0 ** -7}
EMU_MAX_STEPS, EMU_RMS_STEPS = 1.0, 0.125
# "medium" against the JAX package's float32: bf16 operands move each product
# by up to 2^-9 relative, and the K steps compound it; held to MEDIUM_VS_F32
# relative to the largest |value| (read 5.5e-03 for a frame, 4.0e-03 for
# the training forward).
MEDIUM_VS_F32 = 5e-2
REDUCED = ("high", "medium")


# ---------------------------------------------------------------------------
# Independent rounding and the float64 emulation of the JAX kernels
# ---------------------------------------------------------------------------

def np_round(x, precision):
    """The operand rounding of ``precision`` in numpy, float64 -> float64
    (through float32 first)."""
    x32 = np.asarray(x, np.float64).astype(np.float32)
    if precision == "medium":
        return x32.astype(ml_dtypes.bfloat16).astype(np.float64)
    if precision == "high":
        u = x32.view(np.uint32).astype(np.uint64)
        u = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32)
        return u.view(np.float32).astype(np.float64)
    return x32.astype(np.float64)


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _leaky(x):
    return np.where(x >= 0, x, 0.01 * x)


def _f64(tree):
    return {k: np.asarray(v, np.float64) for k, v in tree._asdict().items()}


def emu_frame_step(spec, w, k, z, proj, h, rnd):
    """One reversed step of pallas_flow.py ``_kernel``'s body, float64,
    operands rounded by ``rnd`` at its four dots -> (z, new state)."""
    z1d, half, hd = spec.z1_dim, spec.coupling_out_dim // 2, spec.hidden_channels
    rnn_in = np.concatenate([z[:, :z1d], _leaky(proj)], axis=-1)
    w_ih = w["w_ih_t"][k][:rnn_in.shape[1]]            # JAX pads rows to 8
    gi = rnd(rnn_in) @ rnd(w_ih) + w["b_ih"][k]
    gh = rnd(h) @ rnd(w["w_hh_t"][k]) + w["b_hh"][k]
    r = _sig(gi[:, :hd] + gh[:, :hd])
    zz = _sig(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = np.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
    h_new = (1.0 - zz) * n + zz * h
    hout = rnd(h_new) @ rnd(w["out_w_t"][k]) + w["out_b"][k]
    scale = np.maximum(_sig(hout[:, half:] + 2.0), spec.scale_eps)
    z = np.concatenate([z[:, :z1d], z[:, z1d:] / scale - hout[:, :half]], axis=-1)
    z = rnd(z) @ rnd(w["w_inv"][k])
    return z * w["an_neg_logs_exp"][k] - w["an_bias"][k], h_new


def emu_frame(spec, w, z, cond_projs, states, rnd):
    states = states.copy()
    for k in reversed(range(spec.n_steps)):
        z, states[k] = emu_frame_step(spec, w, k, z, cond_projs[k], states[k], rnd)
    return z, states


def emu_seq(spec, w, w_p1, zs, fixed, hist, states, rnd):
    """pallas_flow.py ``_seq_rev_kernel``: the own-face projection at its
    own rounded dot, then the frame body; the history as a ring buffer."""
    c = spec.channels
    states, xs = states.copy(), []
    for t in range(zs.shape[0]):
        z = zs[t]
        for k in reversed(range(spec.n_steps)):
            proj = fixed[t, k] + rnd(hist) @ rnd(w_p1[k])
            z, states[k] = emu_frame_step(spec, w, k, z, proj, states[k], rnd)
        xs.append(z)
        hist = np.concatenate([hist[:, c:], z], axis=-1)
    return np.stack(xs)


def emu_train_step(spec, tw, k, z, cond, h_prev, rnd):
    """One step of pallas_train.py ``_fwd_kernel`` (and the recompute of
    ``_bwd_kernel``), float64 -> (zb, gi, gh, r, u, n, h_new, hout, sig,
    scale)."""
    z1d, half, hd = spec.z1_dim, spec.coupling_out_dim // 2, spec.hidden_channels
    za = (z + tw["an_bias"][k]) * tw["an_scale"][k]
    zb = rnd(za) @ rnd(tw["w"][k])
    rnn_in = np.concatenate([zb[:, :z1d], _leaky(cond)], axis=-1)
    gi = rnd(rnn_in) @ rnd(tw["w_ih_t"][k][:rnn_in.shape[1]]) + tw["b_ih"][k]
    gh = rnd(h_prev) @ rnd(tw["w_hh_t"][k]) + tw["b_hh"][k]
    r = _sig(gi[:, :hd] + gh[:, :hd])
    u = _sig(gi[:, hd:2 * hd] + gh[:, hd:2 * hd])
    n = np.tanh(gi[:, 2 * hd:] + r * gh[:, 2 * hd:])
    h_new = (1.0 - u) * n + u * h_prev
    hout = rnd(h_new) @ rnd(tw["out_w_t"][k]) + tw["out_b"][k]
    sig = _sig(hout[:, half:] + 2.0)
    return zb, gi, gh, r, u, n, h_new, hout, sig, np.maximum(sig, spec.scale_eps)


def emu_train_fwd(spec, tw, xs, cond, states0, rnd):
    """-> (z_seq, scales, zs_res, states_res)."""
    n_frames = xs.shape[0]
    z1d, half = spec.z1_dim, spec.coupling_out_dim // 2
    states = states0.copy()
    z_seq, scales, zs_res, st_res = [], [], [], []
    for t in range(n_frames):
        z, sc, zr, sr = xs[t], [], [], []
        for k in range(spec.n_steps):
            zr.append(z)
            zb, *_, h_new, hout, _, scale = emu_train_step(
                spec, tw, k, z, cond[t, k], states[k], rnd)
            states[k] = h_new
            sr.append(h_new)
            sc.append(scale)
            z = np.concatenate([zb[:, :z1d], (zb[:, z1d:] + hout[:, :half]) * scale],
                               axis=-1)
        z_seq.append(z)
        scales.append(sc)
        zs_res.append(zr)
        st_res.append(sr)
    return tuple(np.asarray(a) for a in (z_seq, scales, zs_res, st_res))


def emu_train_bwd(spec, tw, cond, zs_res, hprev_all, dz_seq, dscales,
                  dnew_states, rnd):
    """pallas_train.py ``_bwd_kernel`` -> (dx, dstates0, dgi, dghn, dhout,
    dzb)."""
    n_frames, k_steps = dz_seq.shape[0], spec.n_steps
    z1d, half, hd = spec.z1_dim, spec.coupling_out_dim // 2, spec.hidden_channels
    dx = np.zeros_like(dz_seq)
    dstates = dnew_states.copy()
    dgi_all = np.zeros(zs_res.shape[:3] + (3 * hd,))
    dghn_all = np.zeros(zs_res.shape[:3] + (hd,))
    dhout_all = np.zeros(zs_res.shape[:3] + (spec.coupling_out_dim,))
    dzb_all = np.zeros_like(zs_res)
    for t in reversed(range(n_frames)):
        dz = dz_seq[t]
        for k in reversed(range(k_steps)):
            h_prev = hprev_all[t, k]
            zb, gi, gh, r, u, n, _, hout, sig, scale = emu_train_step(
                spec, tw, k, zs_res[t, k], cond[t, k], h_prev, rnd)
            dz2p = dz[:, z1d:]
            dscale = dz2p * (zb[:, z1d:] + hout[:, :half]) + dscales[t, k]
            dsraw = np.where(sig > spec.scale_eps, dscale, 0.0) * sig * (1.0 - sig)
            dhout = np.concatenate([dz2p * scale, dsraw], axis=-1)
            dh_new = rnd(dhout) @ rnd(tw["out_w_t"][k]).T + dstates[k]
            du = dh_new * (h_prev - n)
            dgn = dh_new * (1.0 - u) * (1.0 - n * n)
            dghn = dgn * r
            dgr = dgn * gh[:, 2 * hd:] * r * (1.0 - r)
            dgu = du * u * (1.0 - u)
            dgi = np.concatenate([dgr, dgu, dgn], axis=-1)
            dgh = np.concatenate([dgr, dgu, dghn], axis=-1)
            dstates[k] = dh_new * u + rnd(dgh) @ rnd(tw["w_hh_t"][k]).T
            dz1 = dz[:, :z1d] + (rnd(dgi) @ rnd(tw["w_ih_t"][k][:z1d]).T)
            dzb = np.concatenate([dz1, dz2p * scale], axis=-1)
            dgi_all[t, k], dghn_all[t, k] = dgi, dghn
            dhout_all[t, k], dzb_all[t, k] = dhout, dzb
            dz = (rnd(dzb) @ rnd(tw["w"][k]).T) * tw["an_scale"][k]
        dx[t] = dz
    return dx, dstates, dgi_all, dghn_all, dhout_all, dzb_all


def emu_weight_grads(spec, tw, cond, states0, zs_res, states_res, bwd, rnd):
    """pallas_train.py ``_flow_seq_bwd``'s einsums (each operand rounded) ->
    {TrainWeights field: gradient}, dcond."""
    _, _, dgi, dghn, dhout, dzb = bwd
    z1d, cdim, h = spec.z1_dim, spec.cond.cond_dim, spec.hidden_channels
    ein = lambda eq, a, b: np.einsum(eq, rnd(a), rnd(b))  # noqa: E731
    bias, scale = tw["an_bias"][None, :, None], tw["an_scale"][None, :, None]
    hprev_all = np.concatenate([states0[None], states_res[:-1]], axis=0)
    za = (zs_res + bias) * scale
    z1 = ein("nkbc,kcd->nkbd", za, tw["w"])[..., :z1d]
    dgh = np.concatenate([dgi[..., :2 * h], dghn], axis=-1)
    dza = ein("nkbd,kcd->nkbc", dzb, tw["w"])
    grads = {
        "w": ein("nkbc,nkbd->kcd", za, dzb),
        "an_bias": (dza * scale).sum(axis=(0, 2)),
        "an_scale": (dza * (zs_res + bias)).sum(axis=(0, 2)),
        "w_ih_t": np.concatenate([ein("nkbi,nkbg->kig", z1, dgi),
                                  ein("nkbi,nkbg->kig", _leaky(cond), dgi)], axis=1),
        "w_hh_t": ein("nkbh,nkbg->khg", hprev_all, dgh),
        "b_ih": dgi.sum(axis=(0, 2)),
        "b_hh": dgh.sum(axis=(0, 2)),
        "out_w_t": ein("nkbh,nkbo->kho", states_res, dhout),
        "out_b": dhout.sum(axis=(0, 2)),
    }
    dcond = ein("nkbg,kig->nkbi", dgi, tw["w_ih_t"][:, z1d:z1d + cdim])
    return grads, dcond * np.where(cond > 0, 1.0, 0.01)


def assert_grid(name, got, ref, precision):
    """The largest |got - ref| within EMU_MAX_STEPS grid steps of max|ref|,
    their root mean square within EMU_RMS_STEPS of ref's."""
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    step = GRID[precision]
    err = np.abs(got - ref).max()
    limit = EMU_MAX_STEPS * step * max(np.abs(ref).max(), 1.0)
    assert err <= limit, f"{name} at {precision}: max|d| {err:.3e} > {limit:.3e}"
    rms = np.sqrt(((got - ref) ** 2).mean())
    limit = EMU_RMS_STEPS * step * np.sqrt((ref ** 2).mean())
    assert rms <= limit, f"{name} at {precision}: rms {rms:.3e} > {limit:.3e}"


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------

@functools.cache
def _sampling():
    spec, pspec = specs(tiny_hp())
    params = jax_params(spec)
    model = port_model(params, pspec)
    jw = pallas_flow.prepare_sampling_weights(spec, params.flow)
    pw = fk.prepare_sampling_weights(pspec, model.flow)
    rng = np.random.default_rng(11)
    b, n = 3, 6
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    cond, p1 = spec.cond.cond_dim, spec.cond.p1_face.out_dim
    data = dict(
        z=rng.standard_normal((b, c)).astype(np.float32),
        projs=rng.standard_normal((k, b, cond)).astype(np.float32),
        states=(0.5 * rng.standard_normal((k, b, h))).astype(np.float32),
        zs=rng.standard_normal((n, b, c)).astype(np.float32),
        fixed=rng.standard_normal((n, k, b, cond)).astype(np.float32),
        hist=rng.standard_normal((b, p1)).astype(np.float32),
    )
    w_p1 = np.asarray(params.flow["cond_proj"]["w"])[:, :, :p1].transpose(0, 2, 1)
    return spec, pspec, params, model, jw, pw, np.ascontiguousarray(w_p1), data


@functools.cache
def _training():
    spec, pspec = specs(train_hp())
    params = jax_params(spec)
    model = port_model(params, pspec)
    jtw = pallas_train.prepare_train_weights(spec, params.flow)
    ptw = tk.TrainWeights(*(t.detach().contiguous()
                            for t in tk.prepare_train_weights(pspec, model.flow)))
    rng = np.random.default_rng(5)
    n, b = 4, 3
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    data = dict(
        xs=rng.standard_normal((n, b, c)).astype(np.float32),
        cond=rng.standard_normal((n, k, b, spec.cond.cond_dim)).astype(np.float32),
        states0=(0.1 * rng.standard_normal((k, b, h))).astype(np.float32),
        dz=rng.standard_normal((n, b, c)).astype(np.float32),
        dscales=rng.standard_normal((n, k, b, spec.coupling_out_dim // 2)).astype(np.float32),
        dnew=rng.standard_normal((k, b, h)).astype(np.float32),
    )
    return spec, pspec, params, jtw, ptw, data


def T(x):
    return torch.as_tensor(np.array(x))


# ---------------------------------------------------------------------------
# The mapping and the context manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ambient,mapped", [("highest", "highest"),
                                            ("high", "high"),
                                            ("medium", "medium")])
def test_ambient_precision_mapping(ambient, mapped):
    """torch's setting maps as JAX's does (pallas_flow.py:35): each wrapper's
    precision=None follows it; an explicit precision overrides it."""
    spec, pspec, _, _, _, pw, _, d = _sampling()
    args = (pspec, pw, T(d["z"]), T(d["projs"]), T(d["states"]))
    with matmul_precision(ambient):
        assert fk.ambient_matmul_precision() == mapped
        assert fk.precision_mode(None) == fk.MODES[mapped]
        x_amb, _ = fk.frame_rev_fused(*args)
        x_top, _ = fk.frame_rev_fused(*args, precision="highest")
    assert torch.equal(x_amb, fk.frame_rev_fused_ref(*args, fk.MODES[mapped])[0])
    assert torch.equal(x_top, fk.frame_rev_fused_ref(*args, 0)[0])
    assert torch.get_float32_matmul_precision() == "highest"


def test_matmul_precision_restores_on_error():
    """The manager restores the setting and both TF32 flags after a raise,
    whatever they were."""
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="inside"):
            with matmul_precision("medium"):
                assert torch.get_float32_matmul_precision() == "medium"
                torch.backends.cudnn.allow_tf32 = False
                raise RuntimeError("inside")
        assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32 is True
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("bits,name", [(32, "highest"), (16, "medium"),
                                       (None, "highest")])
def test_training_precision(bits, name):
    class HP:
        precision = bits
    assert training_precision(HP) == name


def test_training_precision_refuses_other_bits():
    class HP:
        precision = 64
    with pytest.raises(ValueError, match="precision 64"):
        training_precision(HP)


# ---------------------------------------------------------------------------
# Rounding
# ---------------------------------------------------------------------------

def _rounding_inputs():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    # ties of both grids, and the largest finite values
    ties = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -11,
                     -(1.0 + 2.0 ** -11), 3.4e38, -3.4e38, 0.0, -0.0], np.float32)
    return np.concatenate([x, ties])


@pytest.mark.parametrize("precision", REDUCED)
def test_round_operand_matches_numpy(precision):
    x = _rounding_inputs()
    got = fk.round_operand(torch.from_numpy(x), fk.MODES[precision]).numpy()
    ref = np_round(x, precision).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    # and on float64 operands through float32
    got64 = fk.round_operand(torch.from_numpy(x.astype(np.float64)),
                             fk.MODES[precision]).numpy()
    np.testing.assert_array_equal(got64, ref.astype(np.float64))


def test_round_tf32_rule():
    """Nearest with ties away from zero on the 10-bit mantissa, the low 13
    bits cleared, NaN kept."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11, float("nan"), float("inf")])
    r = fk.round_tf32(x)
    assert r[0].item() == 1.0 + 2.0 ** -10 and r[1].item() == -(1.0 + 2.0 ** -10)
    assert r[2].item() == 1.0 and r[3].item() == 1.0 + 2.0 ** -9
    assert torch.isnan(r[4]) and r[5].item() == float("inf")
    assert not (r[:4].view(torch.int32) & 0x1FFF).any()


# ---------------------------------------------------------------------------
# The plain versions at the reduced modes against the float64 emulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", REDUCED)
def test_frame_rev_matches_emulation(precision):
    spec, pspec, _, _, jw, pw, _, d = _sampling()
    rnd = functools.partial(np_round, precision=precision)
    x_ref, st_ref = emu_frame(spec, _f64(jw), d["z"].astype(np.float64),
                              d["projs"].astype(np.float64),
                              d["states"].astype(np.float64), rnd)
    x, st = fk.frame_rev_fused(pspec, pw, T(d["z"]), T(d["projs"]), T(d["states"]),
                               precision=precision)
    assert_grid("frame_rev x", x, x_ref, precision)
    assert_grid("frame_rev states", st, st_ref, precision)
    # the kernel's two launches, gates then chain, give the same frame
    hist = torch.zeros(d["z"].shape[0], 0)
    _, gc, gh = fk.sample_gates(pspec, pw, hist.new_zeros((spec.n_steps, 0,
                                                           spec.cond.cond_dim)),
                                T(d["projs"]), hist, T(d["states"]), precision=precision)
    x2, st2, _ = fk.sample_chain(pspec, pw, T(d["z"]), gc, gh, T(d["states"]),
                                 precision=precision)
    assert_grid("gates + chain x", x2, x_ref, precision)
    assert_grid("gates + chain states", st2, st_ref, precision)


@pytest.mark.parametrize("precision", REDUCED)
def test_seq_rev_matches_emulation(precision):
    spec, pspec, _, _, jw, pw, w_p1, d = _sampling()
    rnd = functools.partial(np_round, precision=precision)
    states0 = np.zeros_like(d["states"])
    ref = emu_seq(spec, _f64(jw), w_p1.astype(np.float64),
                  d["zs"].astype(np.float64), d["fixed"].astype(np.float64),
                  d["hist"].astype(np.float64), states0.astype(np.float64), rnd)
    got = fk.sequence_rev_fused(pspec, pw, T(w_p1), T(d["zs"]), T(d["fixed"]),
                                T(d["hist"]), T(states0), precision=precision)
    assert_grid("seq_rev", got, ref, precision)


@pytest.mark.parametrize("precision", REDUCED)
def test_train_forward_matches_emulation(precision):
    spec, pspec, _, jtw, ptw, d = _training()
    rnd = functools.partial(np_round, precision=precision)
    ref = emu_train_fwd(spec, _f64(jtw), d["xs"].astype(np.float64),
                        d["cond"].astype(np.float64),
                        d["states0"].astype(np.float64), rnd)
    got = tk.seq_fwd(pspec, ptw, T(d["xs"]), T(d["cond"]), T(d["states0"]),
                     precision=precision)
    for name, g, r in zip(("z_seq", "scales", "zs_res", "states_res"), got, ref):
        assert_grid(name, g, r, precision)


@pytest.mark.parametrize("precision", REDUCED)
def test_train_backward_matches_emulation(precision):
    spec, pspec, _, jtw, ptw, d = _training()
    rnd = functools.partial(np_round, precision=precision)
    _, _, zs_res, st_res, gc = tk.seq_fwd(pspec, ptw, T(d["xs"]), T(d["cond"]),
                                          T(d["states0"]), precision=precision)
    hprev = torch.cat([T(d["states0"])[None], st_res[:-1]])
    got = tk.seq_bwd(pspec, ptw, gc, zs_res, hprev, T(d["dz"]), T(d["dscales"]),
                     T(d["dnew"]), precision=precision)
    ref = emu_train_bwd(spec, _f64(jtw), d["cond"].astype(np.float64),
                        zs_res.double().numpy(), hprev.double().numpy(),
                        d["dz"].astype(np.float64), d["dscales"].astype(np.float64),
                        d["dnew"].astype(np.float64), rnd)
    for name, g, r in zip(("dx", "dstates0", "dgi", "dghn", "dhout", "dzb"), got, ref):
        assert_grid(name, g, r, precision)


@pytest.mark.parametrize("precision", REDUCED)
def test_function_gradients_match_emulation(precision):
    """The autograd Function at a reduced mode: its forward and its
    backward (ctx carries the mode) against the emulated kernel pair and
    einsums, with the float32 weights' gradients (the rounding is not
    differentiated, as a JAX dot's is not)."""
    spec, pspec, _, jtw, ptw, d = _training()
    rnd = functools.partial(np_round, precision=precision)
    leaves = [t.clone().requires_grad_() for t in ptw]
    inputs = [T(d[k]).requires_grad_() for k in ("xs", "cond", "states0")]
    z, scales, new_states = tk._FlowSequence.apply(pspec, precision, *leaves, *inputs)
    torch.autograd.backward((z, scales, new_states),
                            (T(d["dz"]), T(d["dscales"]), T(d["dnew"])))
    tw64 = _f64(jtw)
    cond64 = d["cond"].astype(np.float64)
    st0 = d["states0"].astype(np.float64)
    z_ref, sc_ref, zs_res, st_res = emu_train_fwd(
        spec, tw64, d["xs"].astype(np.float64), cond64, st0, rnd)
    assert_grid("z_seq", z, z_ref, precision)
    assert_grid("scales", scales, sc_ref, precision)
    hprev = np.concatenate([st0[None], st_res[:-1]])
    bwd = emu_train_bwd(spec, tw64, cond64, zs_res, hprev,
                        d["dz"].astype(np.float64), d["dscales"].astype(np.float64),
                        d["dnew"].astype(np.float64), rnd)
    grads, dcond = emu_weight_grads(spec, tw64, cond64, st0, zs_res, st_res, bwd, rnd)
    for name, leaf in zip(tk.TrainWeights._fields, leaves):
        ref = grads[name][:, :leaf.shape[1]] if name == "w_ih_t" else grads[name]
        assert_grid(f"d{name}", leaf.grad, ref, precision)
    assert_grid("dxs", inputs[0].grad, bwd[0], precision)
    assert_grid("dcond", inputs[1].grad, dcond, precision)
    assert_grid("dstates0", inputs[2].grad, bwd[1], precision)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _jax_frame(spec, jw, d):
    return pallas_flow.frame_rev_fused(spec, jw, d["z"], d["projs"], d["states"],
                                       interpret=True,
                                       precision=jax.lax.Precision.HIGHEST)


def _jax_train_fwd(spec, params, d):
    tw = pallas_train.prepare_train_weights(spec, params.flow)
    z, scales, _, _ = pallas_train._seq_fwd_call(
        spec, 1, True, jax.lax.Precision.HIGHEST, tw, *map(jnp.asarray,
                                                            (d["xs"], d["cond"],
                                                             d["states0"])))
    return np.asarray(z), np.asarray(scales)


def test_highest_matches_jax():
    """The default mode (torch's default "highest") is unchanged: the
    wrappers with precision=None against the JAX kernels at HIGHEST in
    interpret mode, at the port's tolerance."""
    spec, pspec, _, _, jw, pw, _, d = _sampling()
    jx, jst = _jax_frame(spec, jw, d)
    x, st = fk.frame_rev_fused(pspec, pw, T(d["z"]), T(d["projs"]), T(d["states"]))
    assert_close(x, jx, atol=ATOL, rtol=RTOL)
    assert_close(st, jst, atol=ATOL, rtol=RTOL)
    spec, pspec, params, _, ptw, d = _training()
    jz, jsc = _jax_train_fwd(spec, params, d)
    z, scales, *_ = tk.seq_fwd(pspec, ptw, T(d["xs"]), T(d["cond"]), T(d["states0"]))
    assert_close(z, jz, atol=1e-5, rtol=1e-5)
    assert_close(scales, jsc, atol=1e-5, rtol=1e-5)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def test_medium_near_jax_float32():
    """"medium" against the JAX package's float32 result, within a
    bf16-sized bound, and farther from it than "highest" is: each product's
    operands are rounded, none is left out."""
    spec, pspec, _, _, jw, pw, _, d = _sampling()
    jx, _ = _jax_frame(spec, jw, d)
    args = (pspec, pw, T(d["z"]), T(d["projs"]), T(d["states"]))
    e_med = _rel_err(fk.frame_rev_fused(*args, precision="medium")[0], jx)
    e_top = _rel_err(fk.frame_rev_fused(*args, precision="highest")[0], jx)
    assert e_top < 1e-5 < e_med < MEDIUM_VS_F32, (e_top, e_med)
    spec, pspec, params, _, ptw, d = _training()
    jz, _ = _jax_train_fwd(spec, params, d)
    inputs = (T(d["xs"]), T(d["cond"]), T(d["states0"]))
    e_med = _rel_err(tk.seq_fwd(pspec, ptw, *inputs, precision="medium")[0], jz)
    e_top = _rel_err(tk.seq_fwd(pspec, ptw, *inputs, precision="highest")[0], jz)
    assert e_top < 1e-5 < e_med < MEDIUM_VS_F32, (e_top, e_med)


@pytest.mark.parametrize("site", ["frame_rev", "seq_rev", "gates", "chain",
                                  "cond_gates", "seq_fwd", "function"])
def test_unknown_precision_refused(site):
    spec, pspec, _, _, _, pw, w_p1, d = _sampling()
    b = d["z"].shape[0]
    sp, tsp, _, _, ptw, td = _training()
    model = port_model(jax_params(sp), tsp)
    calls = {
        "frame_rev": lambda: fk.frame_rev_fused(pspec, pw, T(d["z"]), T(d["projs"]),
                                                T(d["states"]), precision="bf16"),
        "seq_rev": lambda: fk.sequence_rev_fused(
            pspec, pw, T(w_p1), T(d["zs"]), T(d["fixed"]), T(d["hist"]),
            T(d["states"]), precision="tf32"),
        "gates": lambda: fk.sample_gates(pspec, pw, T(w_p1), T(d["projs"]),
                                         T(d["hist"]), T(d["states"]),
                                         precision="float32"),
        "chain": lambda: fk.sample_chain(
            pspec, pw, T(d["z"]), torch.zeros(spec.n_steps, b, 3 * spec.hidden_channels),
            torch.zeros(spec.n_steps, b, 3 * spec.hidden_channels), T(d["states"]),
            precision="low"),
        "cond_gates": lambda: tk.cond_gates(tsp, ptw, T(td["cond"]), precision="16"),
        "seq_fwd": lambda: tk.seq_fwd(tsp, ptw, T(td["xs"]), T(td["cond"]),
                                      T(td["states0"]), precision="half"),
        "function": lambda: tk.flow_sequence_fused(
            tsp, model.flow, T(td["xs"]), T(td["cond"]), T(td["states0"]),
            precision="default"),
    }
    with pytest.raises(ValueError, match="precision"):
        calls[site]()


@pytest.mark.parametrize("precision", REDUCED)
def test_rounded_weight_sets_are_tagged(precision):
    """A set rounded once for a mode launches as the float32 set does at
    that mode, is taken as it is, and refuses another mode."""
    _, pspec, _, _, _, pw, _, d = _sampling()
    mode = fk.MODES[precision]
    rounded = fk.round_sampling_weights(pspec, pw, mode)
    assert rounded.mode == mode and pw.mode == 0
    assert fk.round_sampling_weights(pspec, rounded, mode) is rounded
    args = (T(d["z"]), T(d["projs"]), T(d["states"]))
    for a, b in zip(fk.frame_rev_fused(pspec, rounded, *args, precision=precision),
                    fk.frame_rev_fused(pspec, pw, *args, precision=precision)):
        assert torch.equal(a, b)
    for other in ("highest", *(p for p in REDUCED if p != precision)):
        with pytest.raises(ValueError, match="cannot run"):
            fk.frame_rev_fused(pspec, rounded, *args, precision=other)


def test_ambient_setting_left_as_found():
    """Runs last in this file: nothing above left torch's matmul settings
    changed for the next test of this worker."""
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False

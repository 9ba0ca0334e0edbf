"""The two plans of each gate kernel, as far as the CPU reaches them.

``cond_gates`` (csrc/cond_gates.cu) runs on the tensor cores ("tc", the
tile product of csrc/gates_mma.cuh; the launcher's at "high" and "medium")
or as a SIMT GEMM in float32 ("simt", the launcher's at "highest");
``sample_gates`` (csrc/sample_gates.cuh) as matrix-vector products below
``GATES_TILE_FROM_ROWS`` rows ("vector") and as tensor-core tiles from
there ("tile", a 3xTF32 split at "highest"). The kernels run only on the
card (chip_smoke.py holds each plan against its plain twin there); here:

* the Python mirrors of the launchers' plan choice give a kernel plan, never
  the plain path, for every spec of the JAX kernels' envelope over the
  whole ``large_hparam_search`` grid, and every tile fits a block;
* the wrappers refuse a plan they do not have;
* the operands the tile plan stages are exact in its storage: a weight
  rounded by ``round_operand`` survives bf16 or TF32 storage bit for bit;
* the 3xTF32 split that the tile plan runs at "highest", emulated in
  float64 with the tensor core's truncating sum, is no farther from the
  float64 product than a float32 chain of fused multiply-adds;
* the gates' plain versions, which the card's kernels are held against,
  still match the JAX package at every mode: at "highest" the JAX kernels'
  dots (HIGHEST) on the JAX package's prepared weights at the training
  forward's limits (atol/rtol 1e-5), at "high" and "medium" the float64
  emulation of their rounding sites at tests/test_torch_precision.py's
  limits.
"""

import itertools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.hparams import load_hparams as jax_load_hparams
from lets_face_it_tpu.ops import pallas_flow
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.ops import train_kernels as tk

from test_torch_envelope import CONDS, EXPRESSION, HS, KS, _grid_hp
from test_torch_port_common import specs
from test_torch_precision import (_leaky, _sampling, _training, T,
                                  assert_grid, np_round)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HPARAMS = Path(__file__).resolve().parent.parent / "hparams"
MODES = ("highest", "high", "medium")
# the training forward's limits (tests/test_pallas_train.py)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
ROWS = (1, 5, 16, 31, 32, 33, 64, 122, 128, 512)


# ---------------------------------------------------------------------------
# The plan mirrors over the envelope
# ---------------------------------------------------------------------------

def _products(ks):
    """(IN, NC) of every product the gate kernels run for kernel spec ks:
    the own-face projection, the hidden gates, the conditioning gates (the
    training forward's cond_gates is the last of them)."""
    cond, h, p1 = ks.cond.cond_dim, ks.hidden_channels, ks.cond.p1_face.out_dim
    prods = [(h, 3 * h), (cond, 3 * h)]
    return prods + ([(p1, cond)] if p1 else [])


@pytest.mark.parametrize("k", KS)
def test_plans_cover_the_envelope_over_the_search_grid(k, tmp_path):
    base = jax_load_hparams(HPARAMS / "final_model.yaml", dataset_root=tmp_path)
    inside = 0
    for h, cond, e in itertools.product(HS, CONDS, EXPRESSION):
        jspec, pspec = specs(_grid_hp(base, k, h, cond, e))
        if not pallas_flow.pallas_supported(jspec):
            continue
        inside += 1
        ks = fk.kernel_spec(pspec)
        # the kernels take the spec, so neither wrapper runs its plain version
        assert tk.train_supported(pspec) and fk.fused_supported(pspec), (k, h, cond, e)
        for mode in fk.MODES.values():
            plan, tile = tk.cond_gates_plan(mode)
            assert 0 <= tile < len(tk.COND_GATES_TILES[plan])
            for b in ROWS:
                assert fk.gates_plan(b, mode=mode) == (
                    "tile" if b >= fk.GATES_TILE_FROM_ROWS[mode] else "vector")
        # the tile plan zero-fills depth to 32 and columns to its tile, and
        # loads 16 bytes at a time: every width a multiple of 4
        assert all(n % 4 == 0 for prod in _products(ks) for n in prod), (k, h, cond, e)
    assert inside == 23 * 3 * 4


@pytest.mark.parametrize("mode", sorted(fk.MODES.values()))
def test_every_tile_fits_a_block(mode):
    for bm, bn, wm, wn, stages in fk.GATES_TILES + tk.COND_GATES_TILES["tc"]:
        assert fk.mma_smem_bytes((bm, bn, wm, wn, stages), mode) <= fk.MAX_SMEM_BYTES
        # warps tile the block; 16-byte chunks of both operands split evenly
        threads = (bm // wm) * (bn // wn) * 32
        assert bm % wm == 0 and bn % wn == 0 and wm % 16 == 0 and wn % 8 == 0
        assert (bm * 8) % threads == 0 and (32 * bn // 4) % threads == 0
    # the launcher's cond_gates tiles keep two blocks an SM (each block
    # also reserves 1 KB): the tensor cores' and the SIMT ring's (128 x 128,
    # a depth of bk in `stages`, rows of bk + 4)
    plan, tile = tk.cond_gates_plan(mode)
    if plan == "tc":
        smem = fk.mma_smem_bytes(tk.COND_GATES_TILES["tc"][tile], mode)
    else:
        bk, stages = tk.COND_GATES_TILES["simt"][tile]
        smem = stages * (128 * (bk + 4) + bk * 128) * 4
    assert 2 * (smem + 1024) <= 233_472


@pytest.mark.parametrize("b", ROWS)
def test_gates_plan_by_rows(b):
    for mode, start in ((0, 64), (1, 16), (2, 16)):
        assert fk.gates_plan(b, mode=mode) == ("tile" if b >= start else "vector")
        # a vector tile asked for keeps the vector plan
        assert fk.gates_plan(b, rows=8, mode=mode) == "vector"
        assert fk.gates_plan(b, groups=32, mode=mode) == "vector"


def test_wrappers_refuse_plans_they_do_not_have():
    spec, pspec, _, _, _, pw, w_p1, d = _sampling()
    args = (pspec, pw, T(w_p1), T(d["projs"]), T(d["hist"]), T(d["states"]))
    for kwargs in ({"plan": "matrix"}, {"plan": "vector", "tile": 0},
                   {"plan": "tile", "rows": 8}, {"tile": len(fk.GATES_TILES)},
                   {"tile": -1}):
        with pytest.raises(ValueError):
            fk.sample_gates(*args, **kwargs)
    _, pspec, _, _, ptw, d = _training()
    for kwargs in ({"plan": "wmma"}, {"plan": "simt", "tile": 4},
                   {"plan": "tc", "tile": len(tk.COND_GATES_TILES["tc"])},
                   {"tile": 0}):
        with pytest.raises(ValueError):
            tk.cond_gates(pspec, ptw, T(d["cond"]), **kwargs)
    # on the CPU every plan request runs the plain version: nothing launched
    launches = (fk.sample_gates.launches, tk.cond_gates.launches)
    fk.sample_gates(*args, plan="tile", tile=1)
    fk.sample_gates(*args, plan="vector", rows=2)
    tk.cond_gates(pspec, ptw, T(d["cond"]), plan="simt")
    assert (fk.sample_gates.launches, tk.cond_gates.launches) == launches


# ---------------------------------------------------------------------------
# Staging: rounded operands are exact in the tensor core's storage
# ---------------------------------------------------------------------------

def _awkward(n=4096, seed=3):
    """Values near rounding boundaries and across exponents, and zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))
    x[:64] = 0.0
    x[64:128] = np.nextafter(np.float32(1.0), np.float32(2.0)) * np.arange(1, 65)
    return torch.as_tensor(x.astype(np.float32))


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_staged_rounding_is_exact_on_rounded_weights(precision):
    mode = fk.MODES[precision]
    w = fk.round_operand(_awkward(), mode)
    bits = w.view(torch.int32)
    if precision == "medium":
        stored = w.to(torch.bfloat16).to(torch.float32)      # cvt.rn.bf16x2.f32
    else:
        stored = (bits & ~0x1FFF).view(torch.float32)        # the tensor core's truncation
    assert torch.equal(stored.view(torch.int32), bits)
    assert torch.equal(fk.round_operand(w, mode).view(torch.int32), bits)
    # the sets the wrappers hand the kernels are so rounded
    _, pspec, _, _, ptw, _ = _training()
    tw = tk.round_train_weights(ptw, mode)
    assert torch.equal(fk.round_operand(tw.w_ih_t, mode), tw.w_ih_t)
    _, pspec, _, _, _, pw, _, _ = _sampling()
    sw = fk.round_sampling_weights(pspec, pw, mode)
    for t in (sw.w_ih_t, sw.w_hh_t):
        assert torch.equal(fk.round_operand(t, mode), t)


# ---------------------------------------------------------------------------
# The 3xTF32 split of "highest"
# ---------------------------------------------------------------------------

def _tf32(x):
    return np_round(x, "high")


def _toward_zero32(x):
    """float64 -> the float32 toward zero (the tensor core's sum), as float64."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(r, np.float32(0.0)), r).astype(np.float64)


def split3_product(a, w):
    """gates_mma.cuh's FLOW_F32 product in float64 emulation: each operand
    x = hi + lo in TF32; per chunk of 8 depths lo*hi, hi*lo, hi*hi summed
    from zero by three tensor-core products (exact products, each sum
    rounded toward zero to float32), then added to a float32 accumulator."""
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], 8):
        s = slice(c0, c0 + 8)
        d = _toward_zero32(al[:, s] @ wh[s])
        d = _toward_zero32(d + ah[:, s] @ wl[s])
        d = _toward_zero32(d + ah[:, s] @ wh[s])
        acc = acc + d.astype(np.float32)
    return acc.astype(np.float64)


def fma_chain(a, w):
    """A float32 chain of fused multiply-adds over the depth."""
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for i in range(a.shape[1]):
        acc = (acc.astype(np.float64) + a[:, i:i + 1] * w[i]).astype(np.float32)
    return acc.astype(np.float64)


def test_tf32_split_recovers_the_operand():
    x = _awkward().numpy().astype(np.float64)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    np.testing.assert_array_equal(_tf32(hi), hi)
    assert (np.abs(hi + lo - x) <= 2.0 ** -22 * np.abs(x)).all()


@pytest.mark.parametrize("depth", [280, 512])
def test_split3_product_is_as_accurate_as_float32(depth):
    rng = np.random.default_rng(depth)
    a = _leaky(rng.standard_normal((96, depth))).astype(np.float32).astype(np.float64)
    w = (0.05 * rng.standard_normal((depth, 64))).astype(np.float32).astype(np.float64)
    exact = a @ w
    rms = lambda got: np.sqrt(((got - exact) ** 2).mean())  # noqa: E731
    r_split, r_chain = rms(split3_product(a, w)), rms(fma_chain(a, w))
    # a plain TF32 product is 2^-11 away: the split must be far below it
    r_tf32 = rms(_tf32(a) @ _tf32(w))
    assert r_split <= r_chain < r_tf32 / 100, (r_split, r_chain, r_tf32)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package
# ---------------------------------------------------------------------------

HI = jax.lax.Precision.HIGHEST


def _jax_cond_gates(spec, jtw, cond):
    """The conditioning rows of pallas_train.py ``_fwd_kernel``'s ``gi`` dot
    (z1 = 0) at HIGHEST on the JAX package's prepared weights."""
    k, n, b = spec.n_steps, cond.shape[0], cond.shape[2]
    rnn_in = jnp.concatenate([jnp.zeros((n, k, b, spec.z1_dim)),
                              jax.nn.leaky_relu(jnp.asarray(cond), 0.01)], -1)
    w = jtw.w_ih_t[:, :rnn_in.shape[-1]]
    return np.asarray(jnp.einsum("nkbi,kig->nkbg", rnn_in, w, precision=HI)
                      + jtw.b_ih[None, :, None])


def _emu_cond_gates(spec, jtw, cond, precision):
    w = np.asarray(jtw.w_ih_t, np.float64)[:, spec.z1_dim:spec.z1_dim + spec.cond.cond_dim]
    x = np_round(_leaky(cond.astype(np.float64)), precision)
    return (np.einsum("nkbi,kig->nkbg", x, np_round(w, precision))
            + np.asarray(jtw.b_ih, np.float64)[None, :, None])


@pytest.mark.parametrize("precision", MODES)
def test_cond_gates_ref_matches_jax(precision):
    spec, pspec, _, jtw, ptw, d = _training()
    mode = fk.MODES[precision]
    got = tk.cond_gates_ref(pspec, tk.round_train_weights(ptw, mode), T(d["cond"]), mode)
    # the wrapper on the CPU is the plain version
    assert torch.equal(tk.cond_gates(pspec, ptw, T(d["cond"]), precision=precision), got)
    if precision == "highest":
        np.testing.assert_allclose(got.numpy(), _jax_cond_gates(spec, jtw, d["cond"]),
                                   **FWD_TOL)
    else:
        assert_grid("cond_gates", got, _emu_cond_gates(spec, jtw, d["cond"], precision),
                    precision)


def _jax_gates(spec, jw, w_p1, fixed, hist, states):
    """The products of pallas_flow.py ``_seq_rev_kernel``'s body that do
    not depend on the chain (its ``gi`` dot with z1 = 0), at HIGHEST."""
    proj = fixed + jnp.einsum("bp,kpc->kbc", hist, w_p1, precision=HI)
    k, b = fixed.shape[:2]
    rnn_in = jnp.concatenate([jnp.zeros((k, b, spec.z1_dim)),
                              jax.nn.leaky_relu(proj, 0.01)], -1)
    w_ih = jw.w_ih_t[:, :rnn_in.shape[-1]]
    gc = jnp.einsum("kbi,kig->kbg", rnn_in, w_ih, precision=HI) + jw.b_ih[:, None]
    gh = jnp.einsum("kbh,khg->kbg", states, jw.w_hh_t, precision=HI) + jw.b_hh[:, None]
    return tuple(map(np.asarray, (proj, gc, gh)))


def _emu_gates(spec, jw, w_p1, fixed, hist, states, precision):
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    rnd = lambda x: np_round(x, precision)  # noqa: E731
    z1, cond = spec.z1_dim, spec.cond.cond_dim
    proj = f64(fixed) + np.einsum("bp,kpc->kbc", rnd(hist), rnd(w_p1))
    gc = (np.einsum("kbi,kig->kbg", rnd(_leaky(proj)), rnd(f64(jw.w_ih_t)[:, z1:z1 + cond]))
          + f64(jw.b_ih)[:, None])
    gh = np.einsum("kbh,khg->kbg", rnd(states), rnd(f64(jw.w_hh_t))) + f64(jw.b_hh)[:, None]
    return proj, gc, gh


@pytest.mark.parametrize("precision", MODES)
def test_sample_gates_ref_matches_jax(precision):
    spec, pspec, _, _, jw, pw, w_p1, d = _sampling()
    mode = fk.MODES[precision]
    inputs = (d["projs"], d["hist"], d["states"])
    got = fk.sample_gates_ref(pspec, pw, T(w_p1), *map(T, inputs), mode)
    for a, b_ in zip(got, fk.sample_gates(pspec, pw, T(w_p1), *map(T, inputs),
                                          precision=precision)):
        assert torch.equal(a, b_)
    if precision == "highest":
        ref = _jax_gates(spec, jw, w_p1, *inputs)
        for name, g, r in zip(("proj", "gc", "gh"), got, ref):
            np.testing.assert_allclose(g.numpy(), r, **FWD_TOL, err_msg=name)
    else:
        ref = _emu_gates(spec, jw, w_p1.astype(np.float64),
                         *(x.astype(np.float64) for x in inputs), precision)
        for name, g, r in zip(("proj", "gc", "gh"), got, ref):
            assert_grid(f"sample_gates {name}", g, r, precision)

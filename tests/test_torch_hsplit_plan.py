"""The hidden-split plan of the two serial training kernels
(``lets_face_it_tpu_torch/ops/train_kernels.py``: ``seq_fwd_hsplit_ref``,
``seq_bwd_hsplit_ref``, ``hsplit_weights``, the plan mirrors).

* its plain versions at clusters of 2 and 4 (each rank's gate columns and
  units, the partials of the coupling head and of dgi @ w_ih[:, :Z1]
  summed in rank order, as ``csrc/seq_{fwd,bwd}_hsplit.cu`` sum them)
  against the walk's plain versions (``seq_fwd_ref``, ``seq_bwd_ref``; atol
  1e-6 / rtol 1e-5: the same products in another grouping, float32) and
  against the JAX package's kernels (``pallas_train._seq_fwd_call``,
  ``_seq_bwd_call``, Pallas in interpret mode on the CPU, the way the JAX
  package's tests run it; atol 2e-5 / rtol 1e-4, the JAX kernel tests'), on
  the same numpy-seeded weights and inputs with TF32 off, at a small spec
  and at H = 1024 with N = 3, K = 2, B = 2;
* the per-block weight layouts against the slices they stand for;
* ``sequence_nll`` and its gradients through the port at H = 1024 (the
  hidden split's plain route on the CPU) against the JAX package's;
* the mirrors over H = 128 ... 1024 x K in {4, 8, 16, 32} x C in {54, 56}:
  the training kernels take every such spec of the JAX kernels' envelope,
  each serial kernel on the plan its launcher takes.

The CUDA kernels are held against these plain versions on the card by
chip_smoke.py (step 18) and ``probe_train_kernels.py --plan hsplit``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu.ops import pallas_train
from lets_face_it_tpu.ops.pallas_flow import pad_w_ih_t
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.ops import train_kernels as tk
from lets_face_it_tpu_torch.sample.weights import seeded_random_model

from conftest import random_batch
from test_torch_port_common import (assert_close, jax_params, port_model, specs,
                                    train_hp)

REPO = Path(__file__).resolve().parent.parent
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JAX_TOL = dict(atol=2e-5, rtol=1e-4)
PLAN_TOL = dict(atol=1e-6, rtol=1e-5)
FWD_OUTPUTS = ("z", "scales", "zs_res", "states_res")
BWD_OUTPUTS = ("dx", "dstates0", "dgi", "dghn", "dhout", "dzb")
# (hidden, K) of the two sizes
WIDTHS = {"small": (32, None), "h1024": (1024, 2)}


def _case_hp(width):
    hp = train_hp()
    h, k = WIDTHS[width]
    hp.Glow["hidden_channels"] = h
    if k:
        hp.Glow["K"] = k
    return hp


def _case(width, n=3, b=2, seed=3):
    """(JAX spec, port spec, JAX prepared weights, port prepared weights,
    the inputs and cotangents as numpy): seeded random weights."""
    spec, pspec = specs(_case_hp(width))
    tw = tk.prepare_train_weights(pspec, seeded_random_model(pspec, seed).flow)
    tw = tk.TrainWeights(*(t.detach() for t in tw))
    jtw = pallas_train.TrainWeights(*(jnp.asarray(t.numpy()) for t in tw))._replace(
        w_ih_t=pad_w_ih_t(jnp.asarray(tw.w_ih_t.transpose(1, 2).numpy())))
    rng = np.random.default_rng(seed)
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inputs = (f32(n, b, c), f32(n, k, b, spec.cond.cond_dim), 0.1 * f32(k, b, h))
    cot = (f32(n, b, c), f32(n, k, b, spec.coupling_out_dim // 2), f32(k, b, h))
    return spec, pspec, jtw, tw, inputs, cot


@pytest.fixture(scope="module")
def cases():
    """Each width's case with the JAX kernels' forward and backward and the
    walk's plain versions, computed once for both clusters."""
    out = {}
    for width in WIDTHS:
        spec, pspec, jtw, tw, inputs, cot = _case(width)
        prec = jax.lax.Precision.HIGHEST
        jfwd = pallas_train._seq_fwd_call(spec, 2, True, prec, jtw,
                                          *map(jnp.asarray, inputs))
        xs, cond, states0 = map(torch.as_tensor, inputs)
        with torch.no_grad():
            walk_fwd = tk.seq_fwd_ref(pspec, tw, xs, cond, states0)
        _, _, zs_res, states_res, gc = walk_fwd
        hprev = torch.cat([states0[None], states_res[:-1]])
        jbwd = pallas_train._seq_bwd_call(
            spec, 2, True, prec, jtw, jnp.asarray(inputs[1]),
            jnp.asarray(zs_res.numpy()), jnp.asarray(hprev.numpy()),
            *map(jnp.asarray, cot))
        cot_t = tuple(map(torch.as_tensor, cot))
        with torch.no_grad():
            walk_bwd = tk.seq_bwd_ref(pspec, tw, gc, zs_res, hprev, *cot_t)
        out[width] = dict(pspec=pspec, tw=tw, fwd_in=(xs, cond, states0),
                          bwd_in=(gc, zs_res, hprev, *cot_t), jfwd=jfwd, jbwd=jbwd,
                          walk_fwd=walk_fwd, walk_bwd=walk_bwd)
    return out


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("cs", [2, 4])
def test_hsplit_forward_equals_the_walk_and_the_jax_kernel(cases, width, cs):
    c = cases[width]
    pspec, tw = c["pspec"], c["tw"]
    with torch.no_grad():
        got = tk.seq_fwd_hsplit_ref(pspec, tw, *c["fwd_in"], cs=cs)
        # the wrapper on CPU tensors runs the plan's plain version
        wrapped = tk.seq_fwd(pspec, tw, *c["fwd_in"], plan="hsplit", tile=(0, cs, 0))
    for name, a, w, wr, j in zip(FWD_OUTPUTS, got, c["walk_fwd"], wrapped, c["jfwd"]):
        assert a.shape == w.shape == j.shape, name
        assert_close(a, w.numpy(), **PLAN_TOL)
        assert torch.equal(wr, a), name
        assert_close(a, np.asarray(j), **JAX_TOL)
    assert torch.equal(got[4], c["walk_fwd"][4])   # gc: cond_gates_ref either way


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("cs", [2, 4])
def test_hsplit_backward_equals_the_walk_and_the_jax_kernel(cases, width, cs):
    c = cases[width]
    pspec, tw = c["pspec"], c["tw"]
    with torch.no_grad():
        got = tk.seq_bwd_hsplit_ref(pspec, tw, *c["bwd_in"], cs=cs)
        wrapped = tk.seq_bwd(pspec, tw, *c["bwd_in"], plan="hsplit", tile=(0, cs, 0))
    for name, a, w, wr, j in zip(BWD_OUTPUTS, got, c["walk_bwd"], wrapped, c["jbwd"]):
        assert a.shape == w.shape == j.shape, name
        assert_close(a, w.numpy(), **PLAN_TOL)
        assert torch.equal(wr, a), name
        assert_close(a, np.asarray(j), **JAX_TOL)


def test_hsplit_weights_are_each_ranks_columns():
    _, pspec, _, tw, _, _ = _case("small", n=1)
    h, z1, cs = pspec.hidden_channels, pspec.z1_dim, 4
    hw = tk.hsplit_weights(pspec, tw, cs)
    units, cols = tk.hsplit_slices(h, cs)
    for r, (u, g) in enumerate(zip(units, cols)):
        assert torch.equal(hw["w_hh"][:, r], tw.w_hh_t[:, :, g])
        assert torch.equal(hw["w_ih"][:, r], tw.w_ih_t[:, :z1][:, :, g])
        assert torch.equal(hw["out_w"][:, r], tw.out_w_t[:, u].transpose(1, 2))
        assert torch.equal(hw["w_ih_z1"][:, r], tw.w_ih_t[:, :z1][:, :, g].transpose(1, 2))
    assert torch.equal(torch.cat(cols).sort().values, torch.arange(3 * h))
    assert all(t.is_contiguous() for t in hw.values())


def test_sequence_nll_at_h1024_matches_jax():
    """Loss, [N, B] losses and every trained parameter's gradient at
    H = 1024 (K = 2), where both serial kernels take the hidden split
    (on the CPU its plain versions), against the JAX package's XLA path."""
    hp = _case_hp("h1024")
    spec, pspec = specs(hp)
    assert pseqglow.training_path(pspec) == "kernels"
    assert tk.seq_fwd_plan_name(pspec) == tk.seq_bwd_plan_name(pspec) == "hsplit"
    params = jax_params(spec, seed=5)
    seq_len, b = hp.Conditioning["p2_face"]["history"] + 3, 2
    data = random_batch(hp, batch_size=b, seq_len=seq_len, seed=6)

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
    n_leaves = 0
    for tree, port_tree in ((jgrads.encoder, model.encoder), (jgrads.flow, model.flow)):
        for jpath, g in jax.tree_util.tree_flatten_with_path(tree)[0]:
            leaf = port_tree
            for key in (p.key for p in jpath):
                leaf = leaf[key]
            if not leaf.requires_grad:
                continue
            got = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            assert_close(got, g, atol=2e-5, rtol=1e-4)
            n_leaves += 1
    assert n_leaves > 0


# H = 128 ... 1024 (multiples of 128, inside the JAX kernels' envelope), K
# and C (expression 50 and 48) of the search grid
ENVELOPE = [(h, k, c) for h in range(128, 1025, 128) for k in (4, 8, 16, 32)
            for c in (54, 56)]


@pytest.mark.parametrize("h, k, c", ENVELOPE)
def test_training_kernels_take_the_envelope_to_h1024(h, k, c, tmp_path):
    """``train_supported`` and ``training_path == "kernels"`` hold, the
    one-row block of each serial kernel on its launcher's plan fits, and the
    plans are the launchers': the walk while a product is at most 1,536
    columns wide (3H <= 1536) and below HSPLIT_FROM_H, else the hidden
    split."""
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model.spec import FlowSpec

    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp_path)
    hp.Glow["hidden_channels"], hp.Glow["K"] = h, k
    hp.Data["expression_dim"] = c - hp.Data["jaw_dim"] - hp.Data["neck_dim"]
    hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = c
    spec = FlowSpec.build(hp)
    assert fk.jax_envelope(spec) and spec.channels == c
    assert tk.train_supported(spec)
    assert pseqglow.training_path(spec) == "kernels"
    want = "hsplit" if 3 * h > 1536 or h >= tk.HSPLIT_FROM_H else "walk"
    assert tk.seq_fwd_plan_name(spec) == tk.seq_bwd_plan_name(spec) == want
    assert tk.train_smem_bytes(spec) <= fk.MAX_SMEM_BYTES
    # the walk cannot take the widths above H = 512
    assert (h <= 512) == (tk.serial_smem_bytes("seq_bwd", spec, "walk") is not None)
    assert tk.hsplit_cluster(spec) == 16

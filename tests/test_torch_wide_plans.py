"""The wide-width plans of the sampling chain and of ``seq_bwd``
(``lets_face_it_tpu_torch/ops/flow_kernels.py``, ``ops/train_kernels.py``).

* ``seq_bwd``'s hidden split: its plain version (``seq_bwd_hsplit_ref``:
  the hidden gates of every frame and step first, ``bwd_gh_ref``, then the
  walk by slices of the hidden units without the two products that read
  w_hh, and each frame's state cotangents of the frame before after it,
  ``bwd_dstate_ref``) against the walk's plain version (``seq_bwd_ref``)
  and against the JAX package's backward kernel
  (``pallas_train._seq_bwd_call``, Pallas in interpret mode on the CPU, the
  way the JAX package's tests run it), on the same weights and residuals,
  at a small spec and at H = 512 with N = 3, K = 2, B = 2. Tolerances:
  against JAX the backward's, atol 2e-5 / rtol 1e-4 (the JAX kernel
  tests'); hidden split against walk atol 1e-6 / rtol 1e-5 (the same
  products in another grouping, float32).
* the plan mirrors, decided from the spec alone as the launchers decide:
  the chain's placement (``chain_placement``) and least shared memory
  (``chain_smem_bytes``), and seq_bwd's plan and block
  (``seq_bwd_plan_name``, ``train_smem_bytes``) at H = 128, 256 and 512.

The CUDA kernels of both plans are held against these plain versions on
the card by chip_smoke.py (step 18) and the probes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.ops import pallas_train
from lets_face_it_tpu.ops.pallas_flow import pad_w_ih_t
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.ops import train_kernels as tk
from lets_face_it_tpu_torch.sample.weights import seeded_random_model

from test_torch_port_common import assert_close, specs, train_hp

REPO = Path(__file__).resolve().parent.parent
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

JAX_TOL = dict(atol=2e-5, rtol=1e-4)
PLAN_TOL = dict(atol=1e-6, rtol=1e-5)
BWD_OUTPUTS = ("dx", "dstates0", "dgi", "dghn", "dhout", "dzb")


def _wide_hp(h=None, k=None):
    hp = train_hp()
    if h:
        hp.Glow["hidden_channels"] = h
    if k:
        hp.Glow["K"] = k
    return hp


def _backward_case(hp, n, b, seed=3):
    """(JAX spec, port spec, JAX prepared weights, port prepared weights,
    cond_seq as numpy, the port's plain forward residuals gc, zs_res and
    hprev, the cotangents as numpy): seeded random weights, numpy inputs."""
    spec, pspec = specs(hp)
    tw = tk.prepare_train_weights(pspec, seeded_random_model(pspec, seed).flow)
    tw = tk.TrainWeights(*(t.detach() for t in tw))
    # the same weights as the JAX kernels take them (w_ih_t's rows padded)
    jtw = pallas_train.TrainWeights(*(jnp.asarray(t.numpy()) for t in tw))._replace(
        w_ih_t=pad_w_ih_t(jnp.asarray(tw.w_ih_t.transpose(1, 2).numpy())))
    rng = np.random.default_rng(seed)
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    xs = rng.standard_normal((n, b, c)).astype(np.float32)
    cond = rng.standard_normal((n, k, b, spec.cond.cond_dim)).astype(np.float32)
    states0 = (0.1 * rng.standard_normal((k, b, h))).astype(np.float32)
    cot = (rng.standard_normal((n, b, c)).astype(np.float32),
           rng.standard_normal((n, k, b, spec.coupling_out_dim // 2)).astype(np.float32),
           rng.standard_normal((k, b, h)).astype(np.float32))
    with torch.no_grad():
        _, _, zs_res, states_res, gc = tk.seq_fwd_ref(
            pspec, tw, *map(torch.as_tensor, (xs, cond, states0)))
    hprev = torch.cat([torch.as_tensor(states0)[None], states_res[:-1]])
    return spec, pspec, jtw, tw, cond, gc, zs_res, hprev, cot


@pytest.mark.parametrize("width", ["small", "h512"])
def test_split_backward_equals_the_walk_and_the_jax_kernel(width):
    hp = _wide_hp() if width == "small" else _wide_hp(h=512, k=2)
    n, b = (2, 2) if width == "small" else (3, 2)
    spec, pspec, jtw, tw, cond, gc, zs_res, hprev, cot = _backward_case(hp, n, b)
    # the launcher's plan: the walk below HSPLIT_FROM_H, the hidden split
    # from it (forced here at the small spec)
    assert tk.seq_bwd_plan_name(pspec) == ("hsplit" if width == "h512" else "walk")
    cot_t = tuple(map(torch.as_tensor, cot))
    with torch.no_grad():
        walk = tk.seq_bwd_ref(pspec, tw, gc, zs_res, hprev, *cot_t)
        split = tk.seq_bwd_hsplit_ref(pspec, tw, gc, zs_res, hprev, *cot_t, cs=2)
        # the wrapper on CPU tensors runs the plan's plain version
        wrapped = tk.seq_bwd(pspec, tw, gc, zs_res, hprev, *cot_t, plan="hsplit",
                             tile=(0, 2, 0))
    want = pallas_train._seq_bwd_call(
        spec, 2, True, jax.lax.Precision.HIGHEST, jtw, jnp.asarray(cond),
        jnp.asarray(zs_res.numpy()), jnp.asarray(hprev.numpy()),
        *map(jnp.asarray, cot))
    for name, s, w, wr, j in zip(BWD_OUTPUTS, split, walk, wrapped, want):
        assert s.shape == w.shape == j.shape, name
        assert_close(s, w.numpy(), **PLAN_TOL)
        assert torch.equal(wr, s), name
        assert_close(s, np.asarray(j), **JAX_TOL)


def test_split_pieces_are_the_walks_products():
    """``bwd_gh_ref`` is the walk's recomputed gh of every (t, k), and
    ``bwd_dstate_ref`` adds dgh @ w_hh_t[k]^T to dh * u, for every k, at
    each matmul precision."""
    _, pspec, _, tw, _, _, _, hprev, _ = _backward_case(_wide_hp(), 3, 2)
    rng = np.random.default_rng(7)
    k, b, h = pspec.n_steps, 2, pspec.hidden_channels
    dgh = torch.as_tensor(rng.standard_normal((k, b, 3 * h)).astype(np.float32))
    dhu = torch.as_tensor(rng.standard_normal((k, b, h)).astype(np.float32))
    for mode in fk.MODES.values():
        rtw = tk.round_train_weights(tw, mode)
        gh = tk.bwd_gh_ref(rtw, hprev, mode)
        ds = tk.bwd_dstate_ref(rtw, dgh, dhu, mode)
        for t in range(hprev.shape[0]):
            for kk in range(k):
                want = (fk.round_operand(hprev[t, kk], mode) @ rtw.w_hh_t[kk]
                        + rtw.b_hh[kk])
                assert_close(gh[t, kk], want.numpy(), **PLAN_TOL)
        for kk in range(k):
            want = dhu[kk] + fk.round_operand(dgh[kk], mode) @ rtw.w_hh_t[kk].T
            assert_close(ds[kk], want.numpy(), **PLAN_TOL)


# (H, K) -> the chain's placement and cluster, its least one-row block
# (bytes), seq_bwd's plan and the serial kernels' larger one-row block on
# their launchers' plans (bytes), at final widths (C = 56)
PLANS = {
    (128, 16): (("resident", 8), 178_528, "walk", 46_688),
    (256, 16): (("resident", 16), 165_824, "hsplit", 20_432),
    (512, 16): (("hsplit", 8), 20_592, "hsplit", 24_944),
    (512, 32): (("hsplit", 8), 20_592, "hsplit", 26_992),
}
# seq_bwd's walk's one-row block where the hidden split is the launcher's
# (bytes): the walk still takes these widths when asked for
WALK_BYTES = {(256, 16): 89_184, (512, 16): 174_176, (512, 32): 206_944}
# the chain's streaming variant's one-row block where its hidden split is
# the plan (bytes): the streaming variant still takes these widths when
# asked for
STREAM_BYTES = {(512, 16): 194_624, (512, 32): 107_488}


@pytest.mark.parametrize("h, k", list(PLANS))
def test_plan_mirrors_place_the_wide_widths(h, k, tmp_path):
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.model.spec import FlowSpec

    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp_path)
    hp.Glow["hidden_channels"], hp.Glow["K"] = h, k
    spec = FlowSpec.build(hp)
    placement, chain_bytes, bwd_plan, bwd_bytes = PLANS[(h, k)]
    assert fk.chain_placement(spec) == placement
    assert fk.chain_resident(spec) == (placement[0] == "resident")
    assert fk.chain_smem_bytes(spec, resident=placement[0] == "resident",
                               hsplit=placement[0] == "hsplit") == chain_bytes
    if (h, k) in STREAM_BYTES:
        assert (fk.chain_smem_bytes(spec, resident=False) == STREAM_BYTES[(h, k)]
                <= fk.MAX_SMEM_BYTES)
    assert chain_bytes <= fk.MAX_SMEM_BYTES and fk.fused_supported(spec)
    assert tk.seq_bwd_plan_name(spec) == bwd_plan
    assert tk.train_smem_bytes(spec) == bwd_bytes <= fk.MAX_SMEM_BYTES
    if (h, k) in WALK_BYTES:
        assert (tk.serial_smem_bytes("seq_bwd", spec, "walk") == WALK_BYTES[(h, k)]
                <= fk.MAX_SMEM_BYTES)
    assert tk.train_supported(spec)


def test_plan_requests_are_checked():
    with pytest.raises(ValueError, match="no plan 'ring'"):
        tk._plan_arg("seq_bwd", "ring", tk.SEQ_BWD_PLANS)
    assert tk._plan_arg("seq_bwd", None, tk.SEQ_BWD_PLANS) is None
    assert [tk._plan_arg("seq_bwd", p, tk.SEQ_BWD_PLANS)
            for p in tk.SEQ_BWD_PLANS] == ["walk", "hsplit"]
    # the split plan is gone: the hidden split took its widths
    with pytest.raises(ValueError, match="no plan 'split'"):
        tk._plan_arg("seq_bwd", "split", tk.SEQ_BWD_PLANS)
    assert fk._chain_tile((1, 16, 1)) == (1, 16, 1, 0)
    assert fk._chain_tile((1, 16, 1, 3)) == (1, 16, 1, 3)
    with pytest.raises(ValueError, match="tile"):
        fk._chain_tile((1, 16))

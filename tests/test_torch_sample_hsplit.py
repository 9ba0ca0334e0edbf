"""The sampling chain's hidden split
(``lets_face_it_tpu_torch/ops/flow_kernels.py``: ``sample_chain_hsplit_ref``,
``chain_hsplit_weights``, the plan mirrors; ``csrc/sample_chain_hsplit.cuh``).

* the mirrors over final_model's widths, H = 128 ... 8,192 (multiples of
  128) x K in {4, 8, 16, 32} x C in {54, 56}: wherever the training kernels
  take a spec, the per-frame and the sequence sampling kernels take it too,
  on the hidden split wherever no cluster holds the chain's weights (the
  streaming variant is no spec's plan there) and always from H = 1,152 on;
  from H = 8,320 neither does;
* its plain version at clusters of 2 and 4 against the chain's
  (``sample_chain_ref``; 1e-6 absolute and relative: the same products in
  another grouping, float32), and the per-block layout against the slices
  it stands for;
* ``sequence_sample`` (injected latents) and ``sequence_invert`` (the
  kernel's route) at H = 1,152, the hidden split's plain versions on the
  CPU, against the JAX package's XLA path at atol 2e-4 / rtol 1e-4.

A spec of the JAX kernels' envelope beyond the ceiling is refused on every
path (``tests/test_torch_envelope.py``). The CUDA kernel is held against
these plain versions on the card by chip_smoke.py (step 18) and
``probe_sampling_kernels.py --plan hsplit``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu_torch.hparams import load_hparams
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.ops import train_kernels as tk
from lets_face_it_tpu_torch.sample.weights import seeded_random_model

from conftest import random_batch, tiny_hparams
from test_torch_port_common import assert_close, jax_params, port_model, specs

REPO = Path(__file__).resolve().parent.parent
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PLAN_TOL = dict(atol=1e-6, rtol=1e-6)
HSPLIT_FROM_H, CEILING_H = 1152, 8192


def _final_hp(tmp_path, k: int, c: int):
    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp_path)
    hp.Glow["K"] = k
    hp.Data["expression_dim"] = c - hp.Data["jaw_dim"] - hp.Data["neck_dim"]
    hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = c
    return hp


@pytest.mark.parametrize("k", [4, 8, 16, 32])
@pytest.mark.parametrize("c", [54, 56])
def test_sampling_kernels_take_every_spec_the_training_kernels_take(k, c, tmp_path):
    hp = _final_hp(tmp_path, k, c)
    trained = []
    for h in range(128, CEILING_H + 129, 128):
        hp.Glow["hidden_channels"] = h
        spec = FlowSpec.build(hp)
        assert fk.jax_envelope(spec) and spec.channels == c
        if not tk.train_supported(spec):
            assert not fk.fused_supported(spec), h
            continue
        trained.append(h)
        assert fk.fused_supported(spec) and fk.sampling_seq_supported(spec), h
        placement = fk.chain_placement(spec)
        resident = fk.chain_smem_bytes(spec) <= fk.MAX_SMEM_BYTES
        assert placement[0] == ("resident" if resident else "hsplit"), (h, placement)
        assert h < HSPLIT_FROM_H or placement[0] == "hsplit", h
        if placement[0] == "hsplit":
            # a cluster of 8 below H = 2,048, of 16 from it (where 8 would
            # give a block more than 1,536 columns, from H = 4,352, too)
            want = 8 if h < fk.CHAIN_HSPLIT_WIDE_FROM_H else 16
            assert placement[1] == fk.chain_hsplit_cluster(spec) == want, h
    # every multiple of 128 up to the ceiling, none beyond it
    assert trained == list(range(128, CEILING_H + 1, 128))


def _small_case(h=64, k=3, seed=0):
    """A K = k flow at C = 56 (Z1 = 28) and H = h with seeded random
    weights, and one frame's inputs at B = 3 with an own-face window."""
    hp = tiny_hparams()
    hp.Data["expression_dim"] = 50
    hp.Glow["K"], hp.Glow["hidden_channels"] = k, h
    hp.Conditioning["cond_dim"] = 128
    hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = 56
    _, spec = specs(hp)
    w = fk.prepare_sampling_weights(spec, seeded_random_model(spec, seed).flow)
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return torch.as_tensor(scale * rng.standard_normal(s).astype(np.float32))

    b, c = 3, spec.channels
    inputs = (f(b, c), f(k, b, 3 * h, scale=0.3), f(k, b, 3 * h, scale=0.3),
              f(k, b, h, scale=0.5), f(b, 2 * c))
    return spec, w, inputs


@pytest.mark.parametrize("cs", [2, 4])
@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_hsplit_plain_version_equals_the_chains(cs, precision):
    spec, w, inputs = _small_case()
    mode = fk.MODES[precision]
    want = fk.sample_chain_ref(spec, w, *inputs, mode)
    got = fk.sample_chain_hsplit_ref(spec, w, *inputs, mode, cs=cs)
    for g, r in zip(got, want):
        assert_close(g, r.numpy(), **PLAN_TOL)
    # the wrapper on CPU tensors runs it when the hidden split is asked for
    wrapped = fk.sample_chain(spec, w, *inputs, precision=precision,
                              tile=(0, cs, 0), hsplit=True)
    for g, r in zip(wrapped, got):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cs", [2, 4])
def test_hsplit_layout_holds_each_ranks_slices(cs):
    """``chain_hsplit_weights``: rank r's slab of step k is its gate
    columns of w_ih_t[k][:Z1], its units' rows of out_w_t[k], W^-1[k], out_b
    (padded to 16 bytes) and the actnorm; the ranks' columns put back
    together give w_ih_t[k][:Z1] again."""
    spec, w, _ = _small_case()
    k, c, z1, h = spec.n_steps, spec.channels, spec.z1_dim, spec.hidden_channels
    cout, hs = spec.coupling_out_dim, h // cs
    lay = fk.chain_hsplit_weights(spec, cs, **w._asdict())
    assert lay.shape == (k, cs, fk._hsplit_rank_floats(spec, cs))
    units, cols = fk.hsplit_slices(h, cs)
    back = torch.empty_like(w.w_ih_t[:, :z1])
    for r, (u, g) in enumerate(zip(units, cols)):
        slab = lay[:, r]
        pieces = torch.split(slab, [z1 * 3 * hs, hs * cout, c * c, (cout + 3) // 4 * 4,
                                    c, c], dim=1)
        back[:, :, g] = pieces[0].unflatten(1, (z1, 3 * hs))
        assert torch.equal(pieces[1].unflatten(1, (hs, cout)), w.out_w_t[:, u])
        assert torch.equal(pieces[2].unflatten(1, (c, c)), w.w_inv)
        assert torch.equal(pieces[3][:, :cout], w.out_b)
        assert torch.equal(pieces[4], w.an_bias)
        assert torch.equal(pieces[5], w.an_neg_logs_exp)
    assert torch.equal(back, w.w_ih_t[:, :z1])
    assert fk.chain_hsplit_weights(spec, 0, **w._asdict()).shape == (k, 0, 0)


def _h1152_case():
    """conftest's tiny config at H = 1,152, K = 4, cond 128, C = 54 (padded
    lanes), the flow perturbed by 0.01 (a wide random flow amplifies
    rounding, as at H = 256, K = 16 in test_torch_envelope.py)."""
    hp = tiny_hparams()
    hp.Data["expression_dim"] = 48
    hp.Glow["K"], hp.Glow["hidden_channels"] = 4, 1152
    hp.Conditioning["cond_dim"] = 128
    hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = 54
    hp.Conditioning["p1_face"]["enc"] = "none"
    spec, pspec = specs(hp)
    assert fk.chain_placement(pspec) == ("hsplit", 8)
    assert pseqglow.sampling_path(pspec) == "sequence"
    return hp, spec, pspec, jax_params(spec, seed=7, scale=0.01)


def _data(hp, spec, b, seq_len, seed):
    data = random_batch(hp, batch_size=b, seq_len=seq_len, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for name in ("p1_face", "p2_face"):
        data[name] = rng.standard_normal((b, seq_len, spec.channels)).astype(np.float32)
    return data


def test_sequence_sample_at_h1152_matches_jax():
    """Generation from injected latents, the sequence kernel's plain version
    on the hidden split, against the JAX package."""
    hp, spec, pspec, params = _h1152_case()
    seq_len, b = hp.Conditioning["p2_face"]["history"] + 3, 1
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


def test_sequence_invert_at_h1152_matches_jax():
    """The teacher-forced inversion on the kernel's route (the per-frame
    kernel's plain version on the hidden split, the logdet from its states)
    against the JAX package."""
    hp, spec, pspec, params = _h1152_case()
    data = _data(hp, spec, 1, hp.Conditioning["p2_face"]["history"] + 3, seed=11)
    n = data["p1_face"].shape[1] - spec.cond.longest_history
    z_seq = np.random.default_rng(12).standard_normal(
        (n, 1, spec.channels)).astype(np.float32)
    want_x, want_loss = jseqglow.sequence_invert(spec, params, z_seq, data)
    x, loss = pseqglow.sequence_invert(
        pspec, port_model(params, pspec), torch.as_tensor(z_seq),
        {k: torch.as_tensor(v) for k, v in data.items()}, route="kernel")
    assert_close(x, want_x)
    assert_close(loss, want_loss)

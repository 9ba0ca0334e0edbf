"""The port's evaluation slice against the JAX package on the CPU:
``sequence_invert`` (through the per-frame kernel's plain version with the
logdet recovered from the GRU states, and through the plain flow), the
invertibility error, ``evaluate_batch`` with the JAX package's draws handed
in, and the ``run_test`` CLI writing the JAX package's ``.npz`` keys.

Tolerance: atol 2e-4 / rtol 1e-4 (the JAX kernel tests'); data bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from lets_face_it_tpu.data.synthetic import write_synthetic_dataset
from lets_face_it_tpu.hparams import HParams as JaxHParams
from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu.train import evaluate as jevaluate
from lets_face_it_tpu.train import metrics as jmetrics
from lets_face_it_tpu_torch import run_test as run_test_cli
from lets_face_it_tpu_torch.data.synthetic import dims_for
from lets_face_it_tpu_torch.model import flow as pflow
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.sample.weights import state_dict_reference
from lets_face_it_tpu_torch.train import evaluate as pevaluate
from lets_face_it_tpu_torch.train import metrics as pmetrics

from conftest import random_batch
from test_torch_port_common import (assert_close, jax_params, port_hp,
                                    port_model, specs, train_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def t(x):
    return torch.as_tensor(np.array(x))


def _config(case):
    """The final-like tiny config and the ablation shapes of the paper's
    Table 1 (hparams/no_face.yaml, no_speech.yaml, no_nll_trick.yaml)."""
    hp = train_hp(0 if case == "no_face" else 16)
    if case == "no_face":
        hp.Conditioning["p2_face"].update(history=0, dim=0)
    if case == "no_speech":
        hp.Conditioning["p2_speech"]["history"] = 0
    if case == "no_nll_trick":
        hp.Train["use_negative_nll_loss"] = False
    return hp


def _batch(hp, spec, b=3, seq_len=12, seed=2):
    data = random_batch(hp, batch_size=b, seq_len=seq_len, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for name in ("p1_face", "p2_face"):
        data[name] = rng.standard_normal((b, seq_len, spec.channels)).astype(np.float32)
    return data


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("case", ["final_like", "no_face", "no_speech",
                                  "no_nll_trick"])
def test_sequence_invert_matches_jax(case, route):
    """Reconstruction and backward loss of latents the JAX package encoded,
    through both routes; the reconstruction also gives back the encoded
    frames."""
    hp = _config(case)
    spec, pspec = specs(hp)
    assert fk.fused_supported(pspec)
    params = jax_params(spec, seed=4)
    data = _batch(hp, spec)
    z_seq, _, _ = jseqglow.sequence_nll(spec, params, data, use_fused=False)
    want_x, want_loss = jseqglow.sequence_invert(spec, params, z_seq, data)
    model = port_model(params, pspec)
    got_x, got_loss = pseqglow.sequence_invert(
        pspec, model, t(z_seq), {k: t(v) for k, v in data.items()}, route=route)
    assert got_x.shape == (3, 12 - spec.cond.longest_history, spec.channels)
    assert_close(got_x, want_x)
    assert_close(got_loss, want_loss)
    start = spec.cond.longest_history
    assert_close(got_x, data["p1_face"][:, start:], atol=1e-3, rtol=1e-3)


def test_kernel_route_logdet_from_states_matches_frame_rev():
    """Per frame, the kernel route (the per-frame kernel's plain version,
    then the logdet from the states it wrote) against ``flow.frame_rev``:
    frames, states and the reverse logdet [N, B]."""
    hp = train_hp()
    spec, pspec = specs(hp)
    model = port_model(jax_params(spec, seed=6), pspec)
    rng = np.random.default_rng(7)
    n, b, k = 5, 4, pspec.n_steps
    zs = t(rng.standard_normal((n, b, pspec.channels)).astype(np.float32))
    projs = t(rng.standard_normal((n, k, b, pspec.cond.cond_dim)).astype(np.float32))
    weights = fk.prepare_sampling_weights(pspec, model.flow)
    with torch.no_grad():
        states_k = states_p = pflow.init_flow_states(pspec, b, "cpu")
        new_states, lds = [], []
        for i in range(n):
            x_k, states_k = fk.frame_rev_fused(pspec, weights, zs[i], projs[i], states_k)
            x_p, ld, states_p = pflow.frame_rev(pspec, model.flow, zs[i], None,
                                                states_p, cond_projs=projs[i])
            assert_close(x_k, x_p)
            assert_close(states_k, states_p)
            new_states.append(states_k)
            lds.append(ld)
        logdet = pseqglow.reverse_logdet_from_states(pspec, weights, model.flow,
                                                     torch.stack(new_states))
    assert logdet.shape == (n, b)
    assert_close(logdet, torch.stack(lds))


def test_inversion_route_by_device_and_envelope():
    _, pspec = specs(train_hp())
    assert pseqglow.inversion_route(pspec, "cuda") == "kernel"
    assert pseqglow.inversion_route(pspec, "cpu") == "plain"
    hp = train_hp()
    hp.Glow["rnn_type"] = "lstm"
    _, lstm = specs(hp)
    assert pseqglow.inversion_route(lstm, "cuda") == "plain"
    with pytest.raises(ValueError, match="route"):
        pseqglow.sequence_invert(pspec, port_model(jax_params(specs(train_hp())[0]),
                                                   pspec),
                                 torch.zeros(2, 1, pspec.channels),
                                 {k: t(v) for k, v in
                                  _batch(train_hp(), pspec, b=1).items()},
                                 route="fused")


def test_invertibility_error_matches_jax():
    hp = train_hp()
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=8)
    data = _batch(hp, spec, b=4)
    z_seq, loss, _ = jseqglow.sequence_nll(spec, params, data, use_fused=False)
    want = jmetrics.invertibility_error(spec, params, data, z_seq, loss)
    model = port_model(params, pspec)
    got = pmetrics.invertibility_error(pspec, model, {k: t(v) for k, v in data.items()},
                                       t(z_seq), t(loss))
    assert_close(got, want, atol=1e-3, rtol=1e-3)
    # the backward logdet is the forward one negated, so the two losses sum
    # to -2 mean(log p(z)) / ln 2 and the error has a closed form
    z = np.asarray(z_seq, np.float64)
    logp = (-0.5 * (z ** 2 + np.log(2 * np.pi))).sum(-1).mean()
    closed = abs(-2.0 * logp / np.log(2.0) / float(loss)) * 100.0
    assert float(got) == pytest.approx(closed, rel=1e-4)


def _jax_eval_draws(spec, hp, key, b):
    """The draws jax evaluate_batch takes from ``key`` (evaluate.py:49-66)."""
    n = hp.Test["seq_len"] - spec.cond.longest_history
    eps = float(hp.Infer["eps"])
    key, k_gen = jax.random.split(key)
    draws = pevaluate.EvalDraws(
        z_free=t(jax.random.normal(k_gen, (n, b, spec.channels)) * eps))
    for m in ("p2_face", "p2_speech", "p1_speech"):
        if hp.Conditioning[m]["history"] <= 0:
            continue
        key, k_der, k_gen = jax.random.split(key, 3)
        draws.perms[m] = t(jax.random.permutation(jax.random.split(k_der)[0], b))
        draws.z_mismatch[m] = t(jax.random.normal(k_gen, (n, b, spec.channels)) * eps)
    return draws


@pytest.mark.parametrize("case", ["final_like", "no_speech"])
def test_evaluate_batch_with_jax_draws_matches_jax(case):
    """Every array of one test batch (NLL, per-frame losses, the free-run and
    deranged generations, the deranged NLLs) with the JAX package's latents
    and permutations handed in."""
    hp = _config(case)
    hp.Test = {"seq_len": 12}
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=9)
    data = _batch(hp, spec, b=4)
    key = jax.random.PRNGKey(13)
    want = jevaluate.evaluate_batch(spec, params, hp, data, key)
    phpp = port_hp(hp)
    phpp.Test = dict(hp.Test)
    got = pevaluate.evaluate_batch(pspec, port_model(params, pspec), phpp,
                                   {k: t(v) for k, v in data.items()},
                                   draws=_jax_eval_draws(spec, hp, key, 4))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == np.asarray(want[name]).shape, name
        assert_close(got[name], want[name])
    np.testing.assert_array_equal(got["gt_seq"], np.asarray(want["gt_seq"]))


def test_draw_eval_order_and_scale():
    """The port's own draws: one latent sequence per generation scaled by
    Infer.eps, one permutation per deranged modality, in a fixed order."""
    hp = port_hp(_config("no_speech"))
    hp.Infer = dict(hp.Infer, eps=0.5)
    _, pspec = specs(_config("no_speech"))
    draws = pevaluate.draw_eval(pspec, hp, 5, torch.Generator().manual_seed(0))
    assert list(draws.perms) == ["p2_face", "p1_speech"]
    n = hp.Validation["seq_len"] - pspec.cond.longest_history
    assert draws.z_free.shape == (n, 5, pspec.channels)
    g = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(draws.z_free,
                                  torch.randn((n, 5, pspec.channels), generator=g) * 0.5)
    assert sorted(draws.perms["p2_face"].tolist()) == list(range(5))


def test_run_test_cli_writes_jax_keys(tmp_path, capsys):
    """The CLI on the CPU over the synthetic corpus's test split: the .npz
    carries exactly the keys JAX's run_test writes for the same split and
    checkpoint, the matched NLL arrays agree with it, every value is finite,
    and the summary is printed."""
    hp = train_hp()
    hp.dataset_root = str(tmp_path / "data")
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=10)
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": state_dict_reference(port_model(params, pspec)),
                "hyper_parameters": vars(hp)}, ckpt)
    out = tmp_path / "res.npz"
    run_test_cli.main(["--ckpt", str(ckpt), "--out", str(out), "--seq_len", "16",
                       "--batch_size", "8", "--max_batches", "2", "--seed", "3",
                       "--synthetic-data", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "saved 2 batch results" in printed and "test_loss:" in printed
    assert "nll_mismatched_p2_face:" in printed

    write_synthetic_dataset(tmp_path / "data" / hp.Data["file_name"], seed=3,
                            dims=dims_for(hp.Data))
    jhp = JaxHParams(**vars(hp))
    jhp.batch_size = 8
    jhp.Test = {"seq_len": 16}
    want_file = tmp_path / "jax.npz"
    jevaluate.run_test(jhp, params, output_file=want_file, seed=3, max_batches=2)
    got, want = np.load(out), np.load(want_file)
    assert sorted(got.files) == sorted(want.files)
    assert "batch1/predicted_mismatch_p1_speech_seq" in got.files
    for name in got.files:
        assert got[name].shape == want[name].shape, name
        assert np.isfinite(got[name]).all(), name
    for name in ("test_loss", "test_losses", "gt_seq"):
        for i in range(2):
            assert_close(got[f"batch{i}/{name}"], want[f"batch{i}/{name}"])


def test_summarize_means_over_batches():
    results = [{"test_loss": np.float32(1.0), "nll_mismatched_p2_face": np.float32(3.0),
                "test_losses": np.ones((2, 2))},
               {"test_loss": np.float32(2.0), "nll_mismatched_p2_face": np.float32(5.0)}]
    assert pevaluate.summarize(results) == jevaluate.summarize(results) == {
        "nll_mismatched_p2_face": 4.0, "test_loss": 1.5}

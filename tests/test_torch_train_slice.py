"""The port's training slice against the JAX package on the CPU: the
teacher-forced NLL and its gradients (through the training kernels' plain
versions and through the plain flow), frame dropout, actnorm init,
derangement, the learning-rate table and clipping, a three-step training
trajectory with the JAX package's random draws handed in, the synthetic
corpus, the windowed batches, and the trainer CLI with checkpoint and resume.

Tolerances: values atol 2e-4 / rtol 1e-4 and gradients atol 2e-5 / rtol 1e-4
(the JAX kernel tests'), data bit for bit; the trajectory's NLL at rtol 1e-5
(tests/test_pallas_train.py:330), its gradient norm at rtol 1e-4 and its
parameters after each Adam step at atol 1e-5, 1 % of the learning rate (Adam
divides each gradient by its own running magnitude, so an entry whose
gradient is near zero moves by up to the learning rate on rounding alone).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from lets_face_it_tpu.data.synthetic import write_synthetic_dataset
from lets_face_it_tpu.data.windows import WindowDataset as JaxWindowDataset
from lets_face_it_tpu.model import encoders as jencoders
from lets_face_it_tpu.model import flow as jflow
from lets_face_it_tpu.model import seqglow as jseqglow
from lets_face_it_tpu.train import derange as jderange
from lets_face_it_tpu.train import optim as joptim
from lets_face_it_tpu.train import state as jstate
from lets_face_it_tpu_torch.data.synthetic import (make_synthetic_corpus,
                                                   tiny_dims)
from lets_face_it_tpu_torch.data.windows import WindowDataset
from lets_face_it_tpu_torch.model import encoders as pencoders
from lets_face_it_tpu_torch.model import flow as pflow
from lets_face_it_tpu_torch.model import seqglow as pseqglow
from lets_face_it_tpu_torch.sample.generate import Generator
from lets_face_it_tpu_torch.train import __main__ as train_cli
from lets_face_it_tpu_torch.train import derange as pderange
from lets_face_it_tpu_torch.train import optim as poptim
from lets_face_it_tpu_torch.train import state as pstate
from lets_face_it_tpu_torch.train.checkpoint import CheckpointManager

from conftest import random_batch
from test_torch_port_common import (assert_close, jax_params, port_model,
                                    specs, tiny_hp, train_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def t(x):
    return torch.as_tensor(np.array(x))


def _batch(hp, spec, b=3, seq_len=12, seed=2):
    data = random_batch(hp, batch_size=b, seq_len=seq_len, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for name in ("p1_face", "p2_face"):
        data[name] = rng.standard_normal((b, seq_len, spec.channels)).astype(np.float32)
    return data


def _port_leaf(model, path):
    """The port's parameter at a JAX tree path (encoder or flow)."""
    for key in path:
        model = model[key]
    return model


def _config(case):
    if case in ("plain", "lstm_coupling"):
        hp = tiny_hp()
        if case == "lstm_coupling":
            hp.Glow["rnn_type"] = "lstm"
        return hp
    hp = train_hp(0 if case == "no_face" else 16)
    if case == "no_speech":
        hp.Conditioning["p2_speech"]["history"] = 0
    hp.Conditioning["use_frame_nb"] = case == "frame_nb"
    return hp


@pytest.mark.parametrize("case, path", [
    ("final_like", "kernels"), ("no_face", "kernels"), ("no_speech", "kernels"),
    ("frame_nb", "kernels"), ("plain", "plain"), ("lstm_coupling", "plain")])
def test_sequence_nll_values_and_gradients_match_jax(case, path):
    """Loss, the [N, B] losses and the gradient on every trained parameter
    (encoders and flow) against the JAX package's XLA path; inside the
    training kernels' envelope through the autograd Function's plain path,
    outside it (C=12, or an LSTM coupling from a zero state) through the
    plain flow; with frame-number conditioning (steps of 2 from
    2 * longest_history)."""
    hp = _config(case)
    spec, pspec = specs(hp)
    assert pseqglow.training_path(pspec) == path
    params = jax_params(spec, seed=1)
    data = _batch(hp, spec)
    data["frame_nb"] = np.array([[3.0], [7.0], [12.0]], np.float32)

    def jloss(p):
        _, loss, losses = jseqglow.sequence_nll(spec, p, data, use_fused=False)
        return loss, losses

    (jl, jlosses), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = port_model(params, pspec)
    _, loss, losses = pseqglow.sequence_nll(pspec, model,
                                            {k: t(v) for k, v in data.items()})
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


def _jax_dropout_masks(spec, key, b, n):
    """The masks jax encode_conditioning draws from ``key``
    (encoders.py:76-80, 145-149)."""
    keys = jax.random.split(key, 4)
    masks = {}
    for i, name in enumerate(jencoders.MODALITY_ORDER):
        es = getattr(spec.cond, name)
        if es is None or es.dropout <= 0 or es.out_dim == 0:
            continue
        masks[name] = t(jax.random.bernoulli(keys[i], 1.0 - es.dropout,
                                             (b, n, es.history)))
    return masks


def test_encode_conditioning_with_jax_dropout_masks():
    hp = train_hp()
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=2)
    data = _batch(hp, spec, b=4)
    times = np.arange(spec.cond.longest_history, 12)
    key = jax.random.PRNGKey(5)
    want = jencoders.encode_conditioning(
        spec.cond, params.encoder, data, data["p1_face"], jnp.asarray(times),
        rng=key, training=True)
    masks = _jax_dropout_masks(spec, key, 4, len(times))
    assert set(masks) == {"p1_speech", "p2_face", "p2_speech"}
    model = port_model(params, pspec)
    with torch.no_grad():
        got = pencoders.encode_conditioning(
            pspec.cond, model.encoder, {k: t(v) for k, v in data.items()},
            t(data["p1_face"]), torch.as_tensor(times), training=True,
            dropout_masks=masks)
        undropped = pencoders.encode_conditioning(
            pspec.cond, model.encoder, {k: t(v) for k, v in data.items()},
            t(data["p1_face"]), torch.as_tensor(times))
    assert_close(got, want)
    assert not np.allclose(undropped.numpy(), np.asarray(want))


def test_actnorm_sequential_init_matches_jax():
    hp = train_hp()
    spec, pspec = specs(hp)
    params = jax_params(spec, seed=3)
    data = _batch(hp, spec, b=4)
    start = spec.cond.longest_history
    cond = jencoders.encode_conditioning(spec.cond, params.encoder, data,
                                         data["p1_face"], jnp.arange(start, start + 1))
    want = jflow.actnorm_sequential_init(spec, params.flow,
                                         data["p1_face"][:, start], cond[:, 0])
    state = pstate.TrainState.create(port_model(params, pspec), hp, 10, seed=0)
    pstate.run_actnorm_init(pspec, state, {k: t(v) for k, v in data.items()})
    for name in ("bias", "logs"):
        assert_close(state.model.flow["actnorm"][name], want["actnorm"][name],
                     atol=1e-5, rtol=1e-5)


def test_derange_batch_with_jax_permutations():
    hp = train_hp()
    spec, _ = specs(hp)
    data = _batch(hp, spec, b=5)
    key = jax.random.PRNGKey(11)
    k_batch, k_time = jax.random.split(key)
    perm = t(jax.random.permutation(k_batch, 5))
    t_perm = t(jax.random.permutation(k_time, 12))
    mods = ["p2_face", "p2_speech"]
    tdata = {k: t(v) for k, v in data.items()}
    for shuffle_time in (False, True):
        want = jderange.derange_batch(key, data, mods, shuffle_time=shuffle_time)
        got = pderange.derange_batch(tdata, mods, perm=perm, time_perm=t_perm,
                                     shuffle_time=shuffle_time)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    assert pderange.mismatched_modalities(hp.Conditioning) == \
        jderange.mismatched_modalities(hp.Conditioning)


@pytest.mark.parametrize("schedule", ["step", "multiplicative", "lambda", None])
def test_epoch_lr_table_matches_jax(schedule):
    hp = train_hp()
    hp.Optim = dict(hp.Optim, Schedule=dict(hp.Optim["Schedule"], name=schedule))
    np.testing.assert_array_equal(poptim.epoch_lr_table(hp, 12),
                                  joptim.epoch_lr_table(hp, 12))


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [(scale * rng.standard_normal(s)).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update(grads, None)
    got = [t(g) for g in grads]
    norm = poptim.clip_by_global_norm(got, 1.0)
    assert_close(norm, optax.global_norm(grads), atol=0, rtol=1e-6)
    for a, b in zip(got, want):
        assert_close(a, b, atol=0, rtol=1e-6)


@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_optimizers_match_optax(name):
    """Three updates of each configured optimizer, with clipping and the
    step schedule, against the JAX package's optax chain."""
    hp = train_hp()
    hp.Optim = dict(hp.Optim, name=name)
    rng = np.random.default_rng(6)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[(10.0 * rng.standard_normal(p.shape)).astype(np.float32)
              for p in params] for _ in range(3)]
    tx = joptim.build_optimizer(hp, steps_per_epoch=1)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    pp = [torch.tensor(p, requires_grad=True) for p in params]
    opt, schedule = poptim.build_optimizer(hp, pp), poptim.LRSchedule(hp, 1)
    for step, g in enumerate(grads):
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = [a + u for a, u in zip(jp, updates)]
        for p, x in zip(pp, g):
            p.grad = t(x)
        poptim.clip_by_global_norm([p.grad for p in pp], hp.gradient_clip_val)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    for a, b in zip(pp, jp):
        assert_close(a, b, atol=1e-6, rtol=1e-5)


def _jax_step_draws(spec, rng, b, n):
    """Replays jax train_state's draws from the step key (state.py:80-84,
    derange.py:21-22, encoders.py:148-149)."""
    _, k_choice, k_derange, k_dropout = jax.random.split(rng, 4)
    coin = float(jax.random.uniform(k_choice))
    perm = t(jax.random.permutation(jax.random.split(k_derange)[0], b))
    return pstate.StepDraws(coin, perm, _jax_dropout_masks(spec, k_dropout, b, n))


def _first_seed_with_derangement(steps=3):
    """The first init seed whose step keys draw a coin below 0.1 within
    ``steps`` steps, so that the trajectory takes the negative branch."""
    for seed in range(100):
        rng = jax.random.split(jax.random.PRNGKey(seed))[1]
        for _ in range(steps):
            rng, k_choice, _, _ = jax.random.split(rng, 4)
            if float(jax.random.uniform(k_choice)) < 0.1:
                return seed
    raise AssertionError("no seed below 100 deranges")


def _copy_jax_params(params, model):
    with torch.no_grad():
        for tree, port_tree in ((params.encoder, model.encoder),
                                (params.flow, model.flow)):
            for jpath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                _port_leaf(port_tree, [p.key for p in jpath]).copy_(t(leaf))


def test_three_step_trajectory_matches_jax():
    """Actnorm init and three optimizer steps (dropout, the negative-NLL
    branch, clipping, Adam with the step schedule) with the JAX package's
    draws handed in: every step's NLL, gradient norm and branch, and the
    parameters after every step. Adam turns a rounding-level gradient into a
    step of up to the learning rate, so the two frameworks' parameters part
    by ~3e-6 per step, and the NLL (gradient norm ~1e3 here) by ~1e-4
    relative: each step therefore starts from the JAX package's parameters,
    while the optimizer state, the step count and the derangement state
    carry over from the port's previous step."""
    hp = train_hp()
    spec, pspec = specs(hp)
    data = _batch(hp, spec, b=4, seq_len=16)
    seed = _first_seed_with_derangement()
    optimizer = joptim.build_optimizer(hp, steps_per_epoch=10)
    jst = jstate.init_train_state(jax.random.PRNGKey(seed), spec, optimizer)
    step = jstate.make_train_step(spec, hp, optimizer, use_fused=False)

    pst = pstate.TrainState.create(port_model(jst.params, pspec), hp, 10, seed=0)
    pdata = {k: t(v) for k, v in data.items()}
    jst = jstate.run_actnorm_init(spec, jst, data)
    pstate.run_actnorm_init(pspec, pst, pdata)
    n = 16 - spec.cond.longest_history
    deranged = []
    for _ in range(3):
        for tree, port_tree in ((jst.params.encoder, pst.model.encoder),
                                (jst.params.flow, pst.model.flow)):
            for jpath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                assert_close(_port_leaf(port_tree, [p.key for p in jpath]), leaf,
                             atol=1e-5, rtol=0)
        _copy_jax_params(jst.params, pst.model)
        draws = _jax_step_draws(spec, jst.rng, 4, n)
        jst, jm = step(jst, data)
        pm = pstate.train_step(pspec, hp, pst, pdata, draws=draws)
        np.testing.assert_allclose(float(pm["nll"]), float(jm["nll"]), rtol=1e-5)
        assert_close(pm["grad_norm"], jm["grad_norm"], atol=0, rtol=1e-4)
        deranged.append((float(jm["deranged"]), float(pm["deranged"])))
    assert any(j == 1.0 for j, _ in deranged)
    assert [p for _, p in deranged] == [j for j, _ in deranged]
    assert pst.step == 3 and math.isclose(pst.last_mismatched_nll,
                                          float(jst.last_mismatched_nll), rel_tol=1e-5)
    for tree, port_tree in ((jst.params.encoder, pst.model.encoder),
                            (jst.params.flow, pst.model.flow)):
        for jpath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            assert_close(_port_leaf(port_tree, [p.key for p in jpath]), leaf,
                         atol=1e-5, rtol=0)


def test_synthetic_corpus_equals_jax_file(tmp_path):
    import h5py

    kwargs = dict(n_train_chunks=2, n_val_chunks=1, n_test_chunks=1,
                  frames_per_chunk=40, seed=3, dims=tiny_dims())
    path = write_synthetic_dataset(tmp_path / "s.h5", **kwargs)
    corpus = make_synthetic_corpus(**kwargs)
    with h5py.File(path, "r") as f:
        for kind in corpus.means:
            np.testing.assert_array_equal(corpus.means[kind], f["means"][kind][()])
            np.testing.assert_array_equal(corpus.stds[kind], f["stds"][kind][()])
        n_arrays = 0
        for split, chunks in corpus.splits.items():
            assert len(f[split]["prosody"]) == len(chunks)
            for i, chunk in enumerate(chunks):
                for kind, pair in chunk.items():
                    for who, arr in pair.items():
                        np.testing.assert_array_equal(
                            arr, f[f"/{split}/{kind}/{i}/{who}"][()])
                        n_arrays += 1
    assert n_arrays == 4 * len(tiny_dims()) * 2


def test_window_batches_equal_jax(tmp_path):
    """The same (seed, epoch) shuffle gives the same batches, from the corpus
    in memory and from the HDF5 file, as the JAX package's WindowDataset."""
    hp = tiny_hp()
    kwargs = dict(n_train_chunks=2, n_val_chunks=1, n_test_chunks=1,
                  frames_per_chunk=40, seed=5, dims=tiny_dims())
    path = write_synthetic_dataset(tmp_path / "s.h5", **kwargs)
    corpus = make_synthetic_corpus(**kwargs)
    args = (hp.Data, hp.Conditioning, 16)
    want = JaxWindowDataset(path, "train", *args)
    for got in (WindowDataset.from_chunks(corpus, "train", *args),
                WindowDataset.from_file(path, "train", *args)):
        assert len(got) == len(want) == 2 * (40 - 16 + 1)
        assert got.num_batches(4, drop_last=True) == want.num_batches(4, drop_last=True)
        sels_got = list(got.epoch_index_batches(4, rng=np.random.default_rng([7, 1]),
                                                drop_last=True))
        sels_want = list(want.epoch_index_batches(4, rng=np.random.default_rng([7, 1]),
                                                  drop_last=True))
        assert len(sels_got) == len(sels_want)
        for a, b in zip(sels_got, sels_want):
            np.testing.assert_array_equal(a, b)
            ga, gb = got.get_batch(a), want.get_batch(b)
            assert list(ga) == list(gb)
            for name in ga:
                np.testing.assert_array_equal(ga[name], gb[name])


def _write_hparams(tmp_path, hp, name="tiny.yaml"):
    path = tmp_path / name
    path.write_text(yaml.safe_dump({k: v for k, v in vars(hp).items()
                                    if k != "config_name"}))
    return path


def _final_params(ckpt_dir):
    payload = torch.load(CheckpointManager(ckpt_dir).latest(), weights_only=True)
    return payload["state_dict"], payload["meta"]


def test_train_cli_checkpoint_generates_and_resumes(tmp_path, capsys):
    """The CLI takes 3 steps on the synthetic corpus with --device cpu and
    validates; its checkpoint loads in Generator.from_checkpoint and
    generates; a run stopped after 2 steps and resumed to 4 ends with the
    parameters of an uninterrupted 4-step run, bit for bit."""
    hp = train_hp()
    hp.batch_size = 32
    cfg = _write_hparams(tmp_path, hp)
    common = [str(cfg), "--synthetic-data", "--device", "cpu", "--seed", "3"]
    train_cli.main(common + ["--max_steps", "3", "--ckpt_dir", str(tmp_path / "a")])
    lines = [yaml.safe_load(s) for s in capsys.readouterr().out.splitlines()
             if s.startswith("{")]
    assert lines[0]["step"] == 3 and math.isfinite(lines[0]["train_loss"])
    assert math.isfinite(lines[0]["grad_norm"])
    assert "val_loss" in lines[1] and "jerk/generated_jerk" in lines[1]
    assert any(k.startswith("mismatched_nll/") for k in lines[1])
    _, meta = _final_params(tmp_path / "a")
    assert meta["step"] == 3 and meta["actnorm_inited"]

    gen = Generator.from_checkpoint(CheckpointManager(tmp_path / "a").latest(),
                                    device="cpu")
    frames = np.random.default_rng(0).standard_normal((14, 273)).astype(np.float32)
    out = gen.generate(frames)
    assert out.shape == (1, 14 - gen.spec.cond.longest_history, 106)
    assert np.isfinite(out).all()

    train_cli.main(common + ["--max_steps", "4", "--ckpt_dir", str(tmp_path / "b")])
    train_cli.main(common + ["--max_steps", "2", "--ckpt_dir", str(tmp_path / "c")])
    train_cli.main(common + ["--max_steps", "4", "--ckpt_dir", str(tmp_path / "c"),
                             "--resume_from", str(tmp_path / "c")])
    whole, meta_b = _final_params(tmp_path / "b")
    resumed, meta_c = _final_params(tmp_path / "c")
    assert meta_b["step"] == meta_c["step"] == 4
    for name, value in whole.items():
        torch.testing.assert_close(resumed[name], value, atol=0, rtol=0)

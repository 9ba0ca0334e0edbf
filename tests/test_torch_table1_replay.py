"""The port trained from the JAX package's start, with its draws replayed.

``write_replay`` exports what the JAX package's Table-1 tool draws
(tools/ablation_table1.py, which trains through lets_face_it_tpu/train/
loop.py::train at seed 1234): the initial weights of ``init_seqglow`` under
the key chain of train() and ``init_train_state``, every step's coin,
batch permutation and frame-dropout masks from the state's key chain
(train/state.py:80), and every validation's probe permutations as the
tool's hook draws them (``PRNGKey(step)``, one split a ``Mismatch`` group).
``lets_face_it_tpu_torch/train/replay.py`` documents the file and reads it
for ``train(replay=)``. The key chain does not depend on the weights, so a
900-step file takes seconds. With ``trajectory=True`` the exporter also
drives the JAX package's own step (``make_train_step(use_fused=False)``)
on the loop's batch order and keeps its per-step NLL, gradient norm and
branch in the file (``ref/*``); the fixture also keeps the validations of
the JAX package's ``train()`` over the same steps (``ref/val/*``).

Run as a script (from the repo root, JAX on the CPU):

    python tests/test_torch_table1_replay.py --write /tmp/replay_final_model.npz \\
        --config final_model [--steps 900] [--seed 1234] [--trajectory]
    python tests/test_torch_table1_replay.py --fixture   # rewrites FIXTURE

then ``python -m lets_face_it_tpu_torch.ablation_table1 --device cpu
--precision 32 --configs final_model,no_nll_trick --replay
/tmp/replay_{config}.npz --reference runs/ablation_table1_jax_cpu.json``.

On the CPU here, at small widths, over the committed fixture
(``FIXTURE``, 24 steps, which ``chip_smoke.py`` step 24 replays on the
card): its draws against the JAX package's own draw functions, the probe
permutations included; the replayed ``train()`` against the JAX package's
``train()`` over the same steps and settings (every validation's
``val_loss`` and probes, as the fixture records them) and against the JAX
package's own steps (the fixture's record); the replay raising past its
end and on a seed, a shape, a spec or a leaf that differs, and on
``steps_per_dispatch`` > 1; and the port's
900-step runs from the JAX start (``runs/ablation_table1_jax_start*``)
against the JAX CPU record and the Table-1 claims.
"""

import copy
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[:0] = [str(REPO), str(REPO / "tests")]

import jax  # noqa: E402  (conftest, imported first, puts JAX on the CPU)
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lets_face_it_tpu.data.synthetic import write_synthetic_dataset  # noqa: E402
from lets_face_it_tpu.hparams import load_hparams as jax_load_hparams  # noqa: E402
from lets_face_it_tpu.model import FlowSpec, init_seqglow  # noqa: E402
from lets_face_it_tpu.model import seqglow as jseqglow  # noqa: E402
from lets_face_it_tpu.train import derange as jderange  # noqa: E402
from lets_face_it_tpu.train import loop as jloop  # noqa: E402
from lets_face_it_tpu.train import metrics as jmetrics  # noqa: E402
from lets_face_it_tpu.train import optim as joptim  # noqa: E402
from lets_face_it_tpu.train import state as jstate  # noqa: E402
from lets_face_it_tpu_torch import ablation_table1  # noqa: E402
from lets_face_it_tpu_torch.data.synthetic import (dims_for,  # noqa: E402
                                                   make_synthetic_corpus)
from lets_face_it_tpu_torch.model.encoders import dropout_mask_shapes  # noqa: E402
from lets_face_it_tpu_torch.model.spec import FlowSpec as PortFlowSpec  # noqa: E402
from lets_face_it_tpu_torch.train import loop as ploop  # noqa: E402
from lets_face_it_tpu_torch.train import metrics as pmetrics  # noqa: E402
from lets_face_it_tpu_torch.train import replay as preplay  # noqa: E402

from test_torch_port_common import port_hp, train_hp  # noqa: E402
from test_torch_train_slice import _jax_step_draws  # noqa: E402

FIXTURE = REPO / "tests" / "fixtures" / "torch_table1_replay_small.npz"
# The small fixture: train_hp's widths with final_model's trick, the tool's
# settings (B=64 on the seed-1234 corpus at those widths: 580 windows of 16,
# 9 steps an epoch), FIXTURE_STEPS steps from the JAX package's seed-1234
# start (its coins first fall below 0.1 at steps 21 and 22, 0-based: both
# fire), a validation every FIXTURE_VAL_EVERY epochs (steps 18 and 24).
FIXTURE_STEPS, FIXTURE_VAL_EVERY, SEED = 24, 2, 1234
GAP_KEY = ablation_table1.GAP_KEY


def jax_table1_hp(config: str, hp=None, val_every: int = 20):
    """The JAX tool's settings (tools/ablation_table1.py:56-66) on
    ``hparams/<config>.yaml``, or on ``hp`` (a copy)."""
    hp = (jax_load_hparams(REPO / "hparams" / f"{config}.yaml") if hp is None
          else copy.deepcopy(hp))
    hp.batch_size = 64
    hp.precision = 16
    hp.max_epochs = 100000
    hp.check_val_every_n_epoch = val_every
    hp.Optim["Schedule"]["args"]["step"]["step_size"] = 300
    hp.Validation.update(inference=False, check_invertion=False,
                         wrong_context_test=False)
    hp.logger = False
    return hp


def port_table1_hp(jhp, precision: int = 32):
    """The port's settings for the same run (``ablation_table1.table1_hparams``:
    the loop's validation computes the probes)."""
    php = port_hp(copy.deepcopy(jhp))
    return ablation_table1.table1_hparams(php, jhp.check_val_every_n_epoch,
                                          precision)


def fixture_hp():
    """The small fixture's JAX config: train_hp's widths, the trick on."""
    hp = train_hp()
    hp.Train["use_negative_nll_loss"] = True
    return jax_table1_hp("final_model", hp, FIXTURE_VAL_EVERY)


def _tree_leaves(prefix: str, tree) -> dict:
    return {prefix + "/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _probe_perms(step: int, mismatch: dict, b: int, t: int) -> dict:
    """The tool's hook: ``PRNGKey(step)``, one split a group in Mismatch
    order (metrics.py:42-49), then derange.py:21-22's split."""
    rng, out = jax.random.PRNGKey(step), {}
    for name, _, shuffle_time in pmetrics.probe_groups(mismatch):
        rng, sub = jax.random.split(rng)
        k_batch, k_time = jax.random.split(sub)
        out[f"probe/{name}/perm"] = np.asarray(jax.random.permutation(k_batch, b))
        if shuffle_time:
            out[f"probe/{name}/time_perm"] = np.asarray(jax.random.permutation(k_time, t))
    return out


def replay_plan(jhp, corpus, steps: int) -> dict:
    """The run's sizes: {spec, port spec, train_ds, val_ds, n_frames,
    val_steps, val_batch, val_seq_len}."""
    php = port_table1_hp(jhp)
    spec, pspec = FlowSpec.build(jhp), PortFlowSpec.build(php)
    train_ds, val_ds = ploop.load_datasets(php, corpus)
    b = jhp.batch_size
    period = jhp.check_val_every_n_epoch * train_ds.num_batches(b, drop_last=True)
    return {"spec": spec, "pspec": pspec, "php": php, "train_ds": train_ds,
            "n_frames": train_ds.seq_len - spec.cond.longest_history,
            "val_steps": sorted(set(range(period, steps + 1, period)) | {steps}),
            "val_batch": min(b, len(val_ds)),
            "val_seq_len": int(jhp.Validation["seq_len"])}


def jax_val_hook(jhp, rows: dict):
    """The JAX tool's hook (tools/ablation_table1.py ``val_hook``): each
    validation's ``val_loss`` and wrong-context probes on the first val
    batch under ``PRNGKey(step)``, into ``rows[step]``."""
    def hook(step, val_loss, hp_, spec, params, val_ds):
        batch = next(val_ds.epoch_batches(jhp.batch_size, shuffle=False))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, base, _ = jseqglow.sequence_nll_jit(spec, params, jb)
        probes = jmetrics.wrong_context_probes(spec, params, jb, base, jhp.Mismatch,
                                               jax.random.PRNGKey(step))
        rows[int(step)] = {"val_loss": float(val_loss),
                           **{k: float(v) for k, v in probes.items()}}
    return hook


def jax_train_validations(jhp, seed: int, steps: int) -> dict:
    """The JAX package's ``train()`` of ``jhp`` (the tool's settings) at
    ``seed`` for ``steps`` steps, on the seed-1234 corpus written anew as
    the HDF5 it reads -> {step: {val_loss, probe: gap}}."""
    rows, jhp = {}, copy.deepcopy(jhp)
    with tempfile.TemporaryDirectory() as root:
        write_synthetic_dataset(Path(root) / jhp.Data["file_name"], seed=SEED,
                                dims=dims_for(port_hp(copy.deepcopy(jhp)).Data))
        jhp.dataset_root = root
        jloop.train(jhp, seed=seed, max_steps=steps, use_mesh=False, verbose=False,
                    val_hook=jax_val_hook(jhp, rows))
    return rows


def jax_trajectory(jhp, spec, train_ds, seed: int, steps: int,
                   anchors=()) -> tuple:
    """The JAX package's own steps as its train() takes them at seed
    ``seed`` (the XLA path, as on the CPU): ActNorm's init on the first
    batch, then ``steps`` steps on the loop's batch order
    (``np.random.default_rng([seed, epoch])``) -> ({nll, grad_norm,
    deranged} [steps] float64, {anchor step: params after it})."""
    b = jhp.batch_size
    optimizer = joptim.build_optimizer(jhp, train_ds.num_batches(b, drop_last=True))
    _, k_state = jax.random.split(jax.random.PRNGKey(seed))
    state = jstate.init_train_state(k_state, spec, optimizer)
    step = jstate.make_train_step(spec, jhp, optimizer, use_fused=False)
    out = {k: [] for k in ("nll", "grad_norm", "deranged")}
    saved, epoch = {}, 0
    while len(out["nll"]) < steps:
        rng = np.random.default_rng([seed, epoch])
        for sel in train_ds.epoch_index_batches(b, rng=rng, shuffle=True,
                                                drop_last=True):
            batch = {k: jnp.asarray(v) for k, v in train_ds.get_batch(sel).items()}
            if not out["nll"]:
                state = jstate.run_actnorm_init(spec, state, batch)
            state, m = step(state, batch)
            for k in out:
                out[k].append(float(m[k]))
            if len(out["nll"]) in anchors:
                saved[len(out["nll"])] = jax.device_get(state.params)
            if len(out["nll"]) == steps:
                break
        epoch += 1
    return {k: np.asarray(v, np.float64) for k, v in out.items()}, saved


def write_replay(path, config: str = "final_model", seed: int = SEED,
                 steps: int = 900, *, hp=None, corpus=None,
                 trajectory: bool = False) -> dict:
    """Write the replay file of the JAX tool's run of ``config`` (or of
    ``hp``, a JAX config with the tool's settings) at ``seed`` for
    ``steps`` steps on ``corpus`` (default: the seed-1234 fixture at the
    config's dims) -> the arrays written."""
    jhp = jax_table1_hp(config) if hp is None else hp
    php0 = port_hp(copy.deepcopy(jhp))
    if corpus is None:
        corpus = make_synthetic_corpus(seed=SEED, dims=dims_for(php0.Data))
    plan = replay_plan(jhp, corpus, steps)
    spec, pspec, b, n = plan["spec"], plan["pspec"], jhp.batch_size, plan["n_frames"]
    # train(): rng, k_state = split(PRNGKey(seed)); init_train_state(k_state)
    _, k_state = jax.random.split(jax.random.PRNGKey(seed))
    k_init, k_rng = jax.random.split(k_state)
    params = init_seqglow(k_init, spec)
    arrays = {**_tree_leaves("param/encoder/", params.encoder),
              **_tree_leaves("param/flow/", params.flow)}
    shapes = dropout_mask_shapes(pspec.cond, b, n)
    coins, perms, masks = [], [], {name: [] for name in shapes}
    for _ in range(steps):
        draws = _jax_step_draws(spec, k_rng, b, n)
        k_rng = jax.random.split(k_rng, 4)[0]
        if set(draws.dropout_masks) != set(shapes):
            raise AssertionError(f"JAX masks {sorted(draws.dropout_masks)}, "
                                 f"port {sorted(shapes)}")
        coins.append(draws.coin)
        perms.append(draws.perm.numpy())
        for name in shapes:
            masks[name].append(draws.dropout_masks[name].numpy())
    arrays["coin"] = np.asarray(coins, np.float32)
    arrays["perm"] = np.stack(perms).astype(np.int64)
    for name, m in masks.items():
        arrays[f"mask/{name}"] = preplay.pack_mask(np.stack(m))
    probes = [_probe_perms(v, jhp.Mismatch, plan["val_batch"], plan["val_seq_len"])
              for v in plan["val_steps"]]
    for key in probes[0]:
        arrays[key] = np.stack([p[key] for p in probes]).astype(np.int64)
    meta = {"format": preplay.FORMAT, "config": config, "seed": seed,
            "steps": steps, "batch_size": b, "n_frames": n,
            "masks": {name: [s[2], float(getattr(pspec.cond, name).dropout)]
                      for name, s in shapes.items()},
            "val_steps": plan["val_steps"], "val_batch": plan["val_batch"],
            "val_seq_len": plan["val_seq_len"],
            "probes": preplay.probe_names(jhp.Mismatch)}
    if trajectory:
        ref, _ = jax_trajectory(jhp, spec, plan["train_ds"], seed, steps)
        arrays.update({f"ref/{k}": v for k, v in ref.items()})
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)
    return arrays


# ---------------------------------------------------------------------------
# The tests, at small widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The small widths' products are too small to share out: one torch
    thread runs this file's replays several times faster on a busy host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def small():
    """The committed fixture (``FIXTURE``: ``write_fixture``'s export), its
    arrays, its JAX config and the seed-1234 corpus in memory."""
    jhp = fixture_hp()
    dims = dims_for(port_hp(copy.deepcopy(jhp)).Data)
    with np.load(FIXTURE) as f:
        arrays = {k: f[k] for k in f.files}
    return {"path": FIXTURE, "arrays": arrays, "hp": jhp,
            "corpus": make_synthetic_corpus(seed=SEED, dims=dims)}


def _coded_batch(b: int, t: int) -> dict:
    """A batch whose every entry of p2_face / p2_speech is its (row, frame)
    code, so that a derangement's output shows its permutations."""
    code = (1000.0 * np.arange(b)[:, None] + np.arange(t)[None, :]).astype(np.float32)
    return {name: np.repeat(code[..., None], 2, -1)
            for name in ("p1_face", "p2_face", "p1_speech", "p2_speech")}


def test_replay_draws_equal_the_jax_step_chain(small):
    """The fixture against the JAX package's own draw functions. Weights:
    ``init_train_state`` under train()'s key. Steps: the coin is
    ``uniform(k_choice) < 0.1``'s draw and the permutation the one
    ``derange_batch(k_derange)`` applies, from the JAX state's key chain as
    its step advances it. Probes: the permutations that ``derange_batch``
    applies under the tool's hook keys, time permutations included. The
    masks are ``_jax_dropout_masks``' (held against ``encode_conditioning``
    in test_torch_train_slice)."""
    jhp, arrays = small["hp"], small["arrays"]
    spec = FlowSpec.build(jhp)
    rep = preplay.Replay(small["path"])
    optimizer = joptim.build_optimizer(jhp, 9)
    _, k_state = jax.random.split(jax.random.PRNGKey(SEED))
    state = jstate.init_train_state(k_state, spec, optimizer)
    want = {**_tree_leaves("param/encoder/", state.params.encoder),
            **_tree_leaves("param/flow/", state.params.flow)}
    assert set(want) == {k for k in arrays if k.startswith("param/")}
    for key, leaf in want.items():
        np.testing.assert_array_equal(arrays[key], leaf)
    b, n = jhp.batch_size, rep.n_frames
    coded = _coded_batch(b, 3)
    rng = state.rng
    for s in range(rep.steps):
        rng, k_choice, k_derange, _ = jax.random.split(rng, 4)
        draws = rep.draws(s)
        assert draws.coin == float(jax.random.uniform(k_choice))
        out = jderange.derange_batch(k_derange, coded, ["p2_face"])
        np.testing.assert_array_equal(draws.perm.numpy(),
                                      np.asarray(out["p2_face"][:, 0, 0]) // 1000)
        for name, mask in draws.dropout_masks.items():
            assert mask.shape == (b, n, getattr(spec.cond, name).history)
    bv, t = rep.meta["val_batch"], rep.meta["val_seq_len"]
    coded = _coded_batch(bv, t)
    for step in rep.val_steps:
        perms = rep.probe_permutations(step, bv, t)
        key = jax.random.PRNGKey(step)
        for shuffle_time, groups in ((False, jhp.Mismatch.get("shuffle_batch", {})),
                                     (True, jhp.Mismatch.get("shuffle_time", {}))):
            for group, mods in groups.items():
                key, sub = jax.random.split(key)
                out = np.asarray(jderange.derange_batch(
                    sub, coded, ["p2_face"], shuffle_time=shuffle_time)["p2_face"])
                kind = "shuffled_time" if shuffle_time else "shuffled_batch"
                perm, time_perm = perms[f"mismatched_nll/{kind}/{group}"]
                np.testing.assert_array_equal(perm.numpy(), out[:, 0, 0] // 1000)
                if shuffle_time:
                    np.testing.assert_array_equal(time_perm.numpy(), out[0, :, 0] % 1000)
                else:
                    assert time_perm is None
    assert len(rep.meta["probes"]) == len(perms)


def test_small_fixture_holds_the_jax_record_and_the_port_config(small):
    """``FIXTURE`` (step 24 of chip_smoke.py replays it on the card): under
    1 MB; FIXTURE_STEPS steps validated at 18 and 24; the JAX run's
    per-step record with the two fired steps and its train()'s
    validations; the port's config of the run in its meta."""
    assert FIXTURE.stat().st_size < 1 << 20
    rep = preplay.Replay(FIXTURE)
    assert rep.steps == FIXTURE_STEPS and rep.val_steps == [18, FIXTURE_STEPS]
    assert rep.meta["hparams"] == json.loads(json.dumps(vars(port_table1_hp(fixture_hp()))))
    ref = rep.reference()
    assert all(v.shape == (FIXTURE_STEPS,) for v in ref.values())
    assert np.flatnonzero(ref["deranged"]).tolist() == [21, 22]
    vals = _jax_validations(small["arrays"])
    assert sorted(vals) == rep.val_steps
    assert all(set(row) == {"val_loss", *rep.meta["probes"]} for row in vals.values())


# The replayed train() against the JAX package's: both in float32 at
# "highest", from one start with one stream of draws, so they part only by
# rounding that Adam (learning rate 1e-3 at this width) carries from step to
# step. The NLL here (about -60 bits a frame) is a small difference of terms
# of thousands of bits, so that rounding moves it by about 2e-6 relative a
# step (4.9e-5 at step 24 against the JAX record; the gradient norm 1.4e-6):
# the first step, from the same weights, at the three-step test's limits
# (NLL rtol 1e-5, gradient norm 1e-4), later steps' NLL at rtol 1e-4 and
# gradient norm at 1e-5; each validation's val_loss at rtol 1e-4 (read
# 5.0e-5 at step 24) and each probe (a gap of 0.012-0.018 bits; the two
# p2 probes 1.6e-3 apart at step 24) at atol 2e-4 (read 3.1e-5).
STEP_NLL_RTOL1, STEP_NLL_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-4, 1e-5
VAL_RTOL, PROBE_ATOL = 1e-4, 2e-4


def _jax_validations(arrays: dict) -> dict:
    """The fixture's record of the JAX package's train() validations:
    {step: {val_loss, probe: gap}}."""
    meta = json.loads(str(arrays["meta"]))
    names = ["val_loss"] + meta["probes"]
    return {step: {k: float(arrays[f"ref/val/{k}"][v]) for k in names}
            for v, step in enumerate(meta["val_steps"])}


def test_replayed_train_equals_jax_train(small):
    """The port's ``train(replay=FIXTURE)`` and the JAX package's
    ``train()`` with the tool's hook, over the fixture's 24 steps at the
    tool's settings (``write_fixture`` records the JAX side): the
    validations' steps, ``val_loss`` and every ``Mismatch`` probe; and
    every step's branch, NLL and gradient norm against the JAX package's
    own steps (the fixture's record)."""
    jhp, jax_rows = small["hp"], _jax_validations(small["arrays"])
    port_rows, steps = {}, []
    ploop.train(port_table1_hp(jhp), seed=SEED, max_steps=FIXTURE_STEPS,
                device="cpu", corpus=small["corpus"], verbose=False,
                replay=small["path"],
                step_hook=lambda s, m: steps.append([float(m[k]) for k in
                                                     ("nll", "grad_norm", "deranged")]),
                val_hook=lambda step, m: port_rows.setdefault(int(step), m))
    assert sorted(port_rows) == sorted(jax_rows) == [18, FIXTURE_STEPS]
    probes = preplay.probe_names(jhp.Mismatch)
    for step, want in jax_rows.items():
        assert set(want) == {"val_loss", *probes}
        np.testing.assert_allclose(port_rows[step]["val_loss"], want["val_loss"],
                                   rtol=VAL_RTOL, atol=0, err_msg=f"step {step}")
        np.testing.assert_allclose([port_rows[step][k] for k in probes],
                                   [want[k] for k in probes], rtol=0, atol=PROBE_ATOL,
                                   err_msg=f"step {step}: {probes}")
    steps, ref = np.asarray(steps), preplay.Replay(FIXTURE).reference()
    np.testing.assert_array_equal(steps[:, 2], ref["deranged"])
    np.testing.assert_allclose(steps[0, 0], ref["nll"][0], rtol=STEP_NLL_RTOL1)
    np.testing.assert_allclose(steps[0, 1], ref["grad_norm"][0], rtol=1e-4)
    np.testing.assert_allclose(steps[:, 0], ref["nll"], rtol=STEP_NLL_RTOL)
    np.testing.assert_allclose(steps[:, 1], ref["grad_norm"], rtol=STEP_GRAD_RTOL)


def _first_steps(arrays: dict, steps: int) -> dict:
    """A replay's arrays cut to its first ``steps`` steps."""
    meta = json.loads(str(arrays["meta"]))
    b, n = meta["batch_size"], meta["n_frames"]
    out = dict(arrays, coin=arrays["coin"][:steps], perm=arrays["perm"][:steps])
    for name, (history, _) in meta["masks"].items():
        full = preplay.unpack_mask(arrays[f"mask/{name}"],
                                   (meta["steps"], b, n, history))
        out[f"mask/{name}"] = preplay.pack_mask(full[:steps])
    out["meta"] = np.asarray(json.dumps({**meta, "steps": steps}))
    return out


def test_replay_raises_past_its_end_and_on_other_shapes(small, tmp_path):
    """A step past the file's end, another batch size, another validation
    step, another width, a missing leaf: each raises, and nothing falls
    back to the port's own generator."""
    php = port_table1_hp(small["hp"])
    run = dict(seed=SEED, device="cpu", corpus=small["corpus"], verbose=False,
               replay=small["path"])
    short = tmp_path / "two_steps.npz"
    np.savez(short, **_first_steps(small["arrays"], 2))
    with pytest.raises(ValueError, match="holds steps 0..1"):
        ploop.train(php, max_steps=3, **{**run, "replay": short})
    php_b = port_table1_hp(small["hp"])
    php_b.batch_size = 32
    with pytest.raises(ValueError, match="batch_size"):
        ploop.train(php_b, max_steps=2, **run)
    with pytest.raises(ValueError, match="validations at"):
        ploop.train(php, max_steps=1, **run)
    php_w = port_table1_hp(small["hp"])
    php_w.Glow = dict(php_w.Glow, hidden_channels=32)
    with pytest.raises(ValueError, match="do not fit the spec"):
        ploop.train(php_w, max_steps=2, **run)
    arrays = dict(small["arrays"])
    dropped = next(k for k in arrays if k.startswith("param/flow/rnn/"))
    del arrays[dropped]
    path = tmp_path / "missing_leaf.npz"
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="missing"):
        ploop.train(php, max_steps=2, **{**run, "replay": path})


def test_replay_raises_on_another_seed(small):
    """The seed still orders each epoch's batches: a run at another seed
    than the file's would mix that seed's batches with the file's draws,
    so it raises."""
    with pytest.raises(ValueError, match="seed 1234, the run has 1235"):
        ploop.train(port_table1_hp(small["hp"]), seed=SEED + 1, max_steps=2,
                    device="cpu", corpus=small["corpus"], verbose=False,
                    replay=small["path"])


def test_replay_refuses_steps_per_dispatch(small):
    """k > 1 would take the k-step function's draws: a replay refuses it
    rather than run one step a dispatch without a word."""
    php = port_table1_hp(small["hp"])
    php.steps_per_dispatch = 5
    php.device_data_cache = "on"
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        ploop.train(php, seed=SEED, max_steps=5, device="cpu",
                    corpus=small["corpus"], verbose=False, replay=small["path"])


# ---------------------------------------------------------------------------
# The port's 900-step runs from the JAX start
# ---------------------------------------------------------------------------

ARTIFACTS = {
    "cpu": REPO / "runs" / "ablation_table1_jax_start_torch.json",
    "card_p16": REPO / "runs" / "ablation_table1_jax_start_card_p16_torch.json",
    "card_p32": REPO / "runs" / "ablation_table1_jax_start_card_p32_torch.json",
}
JAX_CPU = REPO / "runs" / "ablation_table1_jax_cpu.json"
JAX_TPU = REPO / "runs" / "ablation_table1.json"
# Validations before the collapse, where the JAX package's own TPU and CPU
# runs agree best (tests/test_ablation_table1.py reads the TPU's).
SHARED_STEPS = (100, 200, 300, 400, 500, 600)


def _load(path: Path) -> dict:
    assert path.exists(), (f"{path.relative_to(REPO)} missing: run python -m "
                           "lets_face_it_tpu_torch.ablation_table1 --replay (README)")
    return json.loads(path.read_text())


def _jax_spread() -> tuple:
    """The JAX package's own TPU - CPU distance at SHARED_STEPS, both
    configs: (largest |d val_loss|, largest |d gap_p2|); it read 11.0 and
    0.647 bits."""
    tpu, cpu = _load(JAX_TPU), _load(JAX_CPU)
    dv = dg = 0.0
    for name in ablation_table1.PAIR:
        want = {r["step"]: r for r in tpu["configs"][name]["curve"]}
        for r in cpu["configs"][name]["curve"]:
            if r["step"] in SHARED_STEPS:
                dv = max(dv, abs(r["val_loss"] - want[r["step"]]["val_loss"]))
                dg = max(dg, abs(r["gap_p2"] - want[r["step"]]["gap_p2"]))
    return dv, dg


@pytest.mark.parametrize("which", sorted(ARTIFACTS))
def test_jax_start_runs_replayed_the_jax_start(which):
    """Each record: the pair from the replay of the JAX seed-1234 start, 900
    steps validated at 100, ..., 900, every step's NLL kept, the trick's
    steps fired only in final_model, the training kernels launched on the
    card."""
    d = _load(ARTIFACTS[which])
    assert d["start"] == "jax" and set(d["configs"]) == set(ablation_table1.PAIR)
    assert d["precision"] == (16 if which == "card_p16" else 32)
    assert ("NVIDIA" in d["device"]) == which.startswith("card")
    for name, cfg in d["configs"].items():
        assert cfg["start"] == "jax" and cfg["replay_seed"] == SEED
        assert cfg["replay"] == f"replay_{name}.npz" and cfg["max_steps"] == 900
        assert [r["step"] for r in cfg["curve"]] == list(range(100, 901, 100))
        assert len(cfg["step_nll"]) == len(cfg["step_grad_norm"]) == 900
        assert all(math.isfinite(x) for x in cfg["step_nll"] + cfg["step_grad_norm"])
        assert bool(cfg["fired_steps"]) is cfg["use_negative_nll_loss"]
        if which.startswith("card"):
            assert all(n > 0 for n in cfg["launches"].values()), cfg["launches"]


@pytest.mark.parametrize("which", sorted(ARTIFACTS))
def test_jax_start_runs_agree_with_the_jax_cpu_record(which):
    """Every validation carries the JAX CPU record's val_loss and gap at its
    step and the differences; at steps 100-600 the port from the JAX start
    lies within the JAX package's own TPU - CPU distance of that record
    (it read 0.76 bits and 0.146 at most, at precision 16 on the card)."""
    d, ref = _load(ARTIFACTS[which]), _load(JAX_CPU)
    assert d["reference"]["file"] == JAX_CPU.name
    limit_val, limit_gap = _jax_spread()
    for name in ablation_table1.PAIR:
        want = {r["step"]: r for r in ref["configs"][name]["curve"]}
        for r in d["configs"][name]["curve"]:
            w = want[r["step"]]
            assert (r["ref_val_loss"], r["ref_gap_p2"]) == (w["val_loss"], w["gap_p2"])
            assert r["d_val_loss"] == r["val_loss"] - w["val_loss"]
            assert r["d_gap_p2"] == r["gap_p2"] - w["gap_p2"]
            if r["step"] in SHARED_STEPS:
                assert abs(r["d_val_loss"]) <= limit_val, (name, r)
                assert abs(r["d_gap_p2"]) <= limit_gap, (name, r)


@pytest.mark.parametrize("which", sorted(ARTIFACTS))
def test_jax_start_pair_trained_to_plateau_with_its_flags(which):
    """tests/test_ablation_table1.py's plateau and flag claims on the pair:
    at least 5 validations, the optimum below the first and before the
    last, the trick flag of each YAML file."""
    d = _load(ARTIFACTS[which])
    for name in ablation_table1.PAIR:
        cfg = d["configs"][name]
        first, best = cfg["curve"][0]["val_loss"], cfg["best_val"]["val_loss"]
        assert len(cfg["curve"]) >= 5 and math.isfinite(best) and best < first
        assert cfg["best_val"]["step"] < cfg["curve"][-1]["step"]
        assert cfg["use_negative_nll_loss"] is (name == "final_model")


@pytest.mark.parametrize("claim", ["test_nll_trick_amplifies_the_interlocutor_gap",
                                   "test_trick_produces_the_post_optimum_runaway",
                                   "test_trick_costs_no_matched_likelihood"])
@pytest.mark.parametrize("which", sorted(ARTIFACTS))
def test_jax_start_holds_the_table1_claims(which, claim):
    """The three claims of tests/test_ablation_table1.py that read the pair,
    run as that file states them (its thresholds unchanged) on the port's
    runs from the JAX start."""
    import test_ablation_table1

    getattr(test_ablation_table1, claim)(_load(ARTIFACTS[which]))


def write_fixture(path=FIXTURE) -> dict:
    """The small fixture: FIXTURE_STEPS steps of ``fixture_hp`` from the JAX
    package's seed-1234 start, with its per-step trajectory, its train()'s
    validations (``ref/val/<name>`` [V] float64, ``val_loss`` and each
    probe) and the port's config in ``meta["hparams"]`` (``chip_smoke.py``
    has no JAX to build it from)."""
    jhp = fixture_hp()
    arrays = write_replay(path, "final_model", SEED, FIXTURE_STEPS, hp=jhp,
                          trajectory=True)
    meta = json.loads(str(arrays["meta"]))
    rows = jax_train_validations(jhp, SEED, FIXTURE_STEPS)
    if sorted(rows) != meta["val_steps"]:
        raise AssertionError(f"JAX validated at {sorted(rows)}, the file at "
                             f"{meta['val_steps']}")
    for name in ["val_loss"] + meta["probes"]:
        arrays[f"ref/val/{name}"] = np.asarray([rows[v][name] for v in meta["val_steps"]])
    meta["hparams"] = vars(port_table1_hp(jhp))
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(path, **arrays)
    return arrays


def jax_table1_record(config: str, seed: int, dataset_root, max_steps: int = 900) -> dict:
    """The JAX tool's run of ``config`` (tools/ablation_table1.py::run_config,
    which fixes seed 1234) at ``seed``: the JAX package's ``train()`` with
    the tool's settings and its hook's probes -> the tool's record."""
    import time

    jhp = jax_table1_hp(config)
    jhp.dataset_root = str(dataset_root)
    rows, curve = {}, []
    probe_hook = jax_val_hook(jhp, rows)

    def val_hook(step, *args):
        probe_hook(step, *args)
        curve.append({"step": int(step), "val_loss": rows[int(step)]["val_loss"],
                      "gap_p2": rows[int(step)][GAP_KEY]})
        print(f"[{config} seed {seed}] step {step}: val_loss {curve[-1]['val_loss']:.2f} "
              f"gap(p2) {curve[-1]['gap_p2']:+.3f}", flush=True)

    t0 = time.time()
    jloop.train(jhp, seed=seed, log_dir=None, ckpt_dir=None, max_steps=max_steps,
                use_mesh=False, verbose=False, val_hook=val_hook)
    return {"config": config, "seed": seed,
            "use_negative_nll_loss": bool(jhp.Train["use_negative_nll_loss"]),
            "max_steps": max_steps, "wall_s": round(time.time() - t0, 1),
            "curve": curve, "best_val": min(curve, key=lambda r: r["val_loss"]),
            "extreme_gap_p2": ablation_table1.extreme_gap(curve)}


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Write a replay file of the JAX "
                                "package's Table-1 run (see the module's doc).")
    p.add_argument("--write", help="the replay file to write")
    p.add_argument("--config", default="final_model")
    p.add_argument("--steps", type=int, default=900)
    p.add_argument("--seed", type=int, default=SEED)
    p.add_argument("--trajectory", action="store_true",
                   help="also run the JAX package's steps and keep their metrics")
    p.add_argument("--fixture", action="store_true",
                   help=f"rewrite {FIXTURE.relative_to(REPO)}")
    p.add_argument("--jax_seed", type=int, default=None,
                   help="run the JAX package's Table-1 configs at this seed on the CPU")
    p.add_argument("--configs", default="final_model,no_nll_trick")
    p.add_argument("--out", default=None, help="the --jax_seed record")
    args = p.parse_args(argv)
    if args.jax_seed is not None:
        if not args.out:
            p.error("--jax_seed needs --out")
        record = {"device": jax.devices()[0].device_kind,
                  "fixture": "small synthetic (4 train chunks x 160 frames, planted "
                             "mimicry lag 8; seed 1234)",
                  "gap_key": GAP_KEY, "seed": args.jax_seed,
                  "script": "tests/test_torch_table1_replay.py --jax_seed: the JAX "
                            "package's train() with tools/ablation_table1.py's "
                            "settings and hook at another seed", "configs": {}}
        with tempfile.TemporaryDirectory() as root:   # the corpus written anew
            for name in args.configs.split(","):
                write_synthetic_dataset(
                    Path(root) / jax_table1_hp(name).Data["file_name"], seed=SEED)
                record["configs"][name] = jax_table1_record(name, args.jax_seed,
                                                            root, args.steps)
                Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    if args.fixture:
        arrays = write_fixture()
        print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes), fired at steps "
              f"{np.flatnonzero(arrays['ref/deranged']).tolist()}")
    if args.write:
        write_replay(args.write, args.config, args.seed, args.steps,
                     trajectory=args.trajectory)
        print(f"wrote {args.write}")


if __name__ == "__main__":
    main()

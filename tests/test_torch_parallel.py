"""Data parallelism of the port (``lets_face_it_tpu_torch/parallel/mesh.py``)
on the CPU: two ranks over gloo, started by ``torch.multiprocessing``
(spawn), against one process (the port's, or the JAX package's single
device step) on the same weights, batches and draws.

The ranks run every case once, in one spawn (``ddp``); each test reads its
case. Limits: a step against the JAX package's as tests/test_parallel.py
holds the 8-device mesh to one device (NLL rtol 1e-5, parameters atol
2e-5); the port on two ranks against itself on one, likewise; the k-step
function against single steps, and the ranks' copies of a result against
each other, bit for bit; the actnorm init (the encoders of half the rows)
at atol 1e-6 / rtol 1e-5; sampling at atol 1e-5 (tests/test_parallel.py:124);
the split fit against the unsplit one at atol 1e-5 / rtol 1e-4 (the ranks
run one thread, so their products sum in another order than this
process's: tests/test_torch_flame_fit.py holds the chunks of one process
bit for bit).
"""

import os
import socket

import numpy as np
import pytest
import torch

from lets_face_it_tpu_torch.data.device_cache import gather_windows
from lets_face_it_tpu_torch.model.seqglow import SeqGlow, sequence_sample
from lets_face_it_tpu_torch.parallel import mesh as pmesh
from lets_face_it_tpu_torch.train import state as pstate
from lets_face_it_tpu_torch.train.loop import synthetic_corpus, train

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

RANKS, B = 2, 4


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _model(spec, state_dict):
    model = SeqGlow.init(spec, torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict)
    return model


def _cases(mesh, inp):
    """Every case on this rank -> {case: result}."""
    out = {}
    hp, spec = inp["hp"], inp["spec"]

    # one step, the trick off, from the JAX package's weights and draws
    st = pstate.TrainState.create(_model(spec, inp["jax_weights"]), hp, 10,
                                  seed=0, mesh=mesh)
    m = pstate.train_step(spec, hp, st, pmesh.shard_batch(mesh, inp["batch"]),
                          draws=inp["jax_draws"])
    out["jax_step"] = (float(m["nll"]), _params(st.model))

    # two steps, the trick on (the second deranged)
    hp_trick = inp["hp_trick"]
    st = pstate.TrainState.create(_model(spec, inp["weights"]), hp_trick, 10,
                                  seed=0, mesh=mesh)
    steps = [pstate.train_step(spec, hp_trick, st, pmesh.shard_batch(mesh, inp["batch"]),
                               draws=d) for d in inp["trick_draws"]]
    out["trick"] = ([float(s["nll"]) for s in steps],
                    [float(s["deranged"]) for s in steps], _params(st.model))

    # actnorm init from the global batch
    st = pstate.TrainState.create(_model(spec, inp["fresh"]), hp, 10, seed=0,
                                  mesh=mesh)
    pstate.run_actnorm_init(spec, st, pmesh.shard_batch(mesh, inp["batch"]))
    out["actnorm"] = {k: v.detach().clone()
                      for k, v in st.model.flow["actnorm"].items()}

    # sampling split over the ranks
    with torch.no_grad():
        out["sample"] = sequence_sample(spec, _model(spec, inp["weights"]),
                                        inp["sample_data"], inp["seq_len"],
                                        z_seq=inp["z_seq"], mesh=mesh)

    # k = 3 steps in one call against three single steps
    arrays, starts = inp["arrays"], inp["starts"]
    local_starts = starts[:, mesh.rows(B)]
    results = []
    for k in (3, 1):
        st = pstate.TrainState.create(_model(spec, inp["weights"]), hp_trick, 10,
                                      seed=5, mesh=mesh)
        if k == 3:
            nll = pstate.MultiStep(spec, hp_trick, st, arrays, inp["seq_len"], B,
                                   3)(local_starts)["nll"].tolist()
        else:
            nll = [float(pstate.train_step(
                spec, hp_trick, st,
                gather_windows(arrays, local_starts[i], inp["seq_len"]))["nll"])
                for i in range(3)]
        results.append((nll, _params(st.model)))
    out["k_steps"] = results

    # the fit split over the ranks
    from lets_face_it_tpu_torch.features import flame_fit as fit
    from lets_face_it_tpu_torch.render.flame import synthetic_flame_model

    head = synthetic_flame_model(160, seed=1, device="cpu")
    emb = fit.synthetic_landmark_embedding(head, seed=2)
    params, losses, evals = fit.fit_batch(head, emb, inp["targets"], mesh=mesh,
                                          **inp["fit_steps"])
    out["fit"] = (params, losses, evals)

    # whole runs: three steps and a validation; a hook's stop on rank 0
    _, best = train(inp["hp_run"], seed=3, max_steps=3, device="cpu",
                    corpus=inp["corpus"], verbose=False, mesh=mesh,
                    ckpt_dir=inp["ckpt_dirs"][mesh.rank])
    out["train"] = best

    def hook(step, metrics):
        if step == 2:
            raise StopIteration(f"stopped at {step} on rank {mesh.rank}")

    try:
        train(inp["hp_run"], seed=3, max_steps=5, device="cpu",
              corpus=inp["corpus"], verbose=False, mesh=mesh, step_hook=hook)
        out["hook"] = None
    except StopIteration as exc:
        out["hook"] = str(exc)
    return out


def _worker(rank, port, inputs_path, out_dir):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(RANKS), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, RANKS, "gloo")
    out = _cases(mesh, torch.load(inputs_path, weights_only=False))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(tmp):
    """The JAX package's step and the single-process references (in this
    process), and what the ranks need."""
    import jax

    from lets_face_it_tpu.train import optim as joptim
    from lets_face_it_tpu.train import state as jstate
    from test_torch_port_common import port_hp, port_model, specs, train_hp
    from test_torch_train_slice import _batch, _jax_step_draws

    hp = train_hp()
    hp.Train["use_negative_nll_loss"] = False
    jspec, spec = specs(hp)
    php = port_hp(hp)
    data = _batch(hp, jspec, b=B, seq_len=16)
    batch = {k: torch.as_tensor(v) for k, v in data.items()}
    n = 16 - jspec.cond.longest_history
    optimizer = joptim.build_optimizer(hp, steps_per_epoch=10)
    jst = jstate.init_train_state(jax.random.PRNGKey(0), jspec, optimizer)
    jst = jstate.run_actnorm_init(jspec, jst, data)
    jax_weights = port_model(jst.params, spec).state_dict()
    jax_draws = _jax_step_draws(jspec, jst.rng, B, n)
    jst, jm = jstate.make_train_step(jspec, hp, optimizer, use_fused=False)(jst, data)
    want = {"jax_step": (float(jm["nll"]), port_model(jst.params, spec).state_dict())}

    hp_trick = port_hp(hp)
    hp_trick.Train = {**hp_trick.Train, "use_negative_nll_loss": True}
    weights = jax_weights
    gen = torch.Generator().manual_seed(11)
    trick_draws = []
    for coin in (0.5, 0.05):
        d = pstate.draw_step(spec, pstate.TrainState(
            None, None, None, gen), B, n)
        trick_draws.append(pstate.StepDraws(coin, d.perm, d.dropout_masks))
    st = pstate.TrainState.create(_model(spec, weights), hp_trick, 10, seed=0)
    steps = [pstate.train_step(spec, hp_trick, st, batch, draws=d) for d in trick_draws]
    want["trick"] = ([float(s["nll"]) for s in steps],
                     [float(s["deranged"]) for s in steps], _params(st.model))

    fresh = SeqGlow.init(spec, torch.Generator().manual_seed(4)).state_dict()
    st = pstate.TrainState.create(_model(spec, fresh), php, 10, seed=0)
    pstate.run_actnorm_init(spec, st, batch)
    want["actnorm"] = {k: v.detach().clone() for k, v in st.model.flow["actnorm"].items()}

    seq_len = 14
    sample_data = {k: torch.as_tensor(v) for k, v in
                   _batch(hp, jspec, b=B, seq_len=seq_len, seed=5).items()}
    z_seq = torch.randn((seq_len - jspec.cond.longest_history, B, jspec.channels),
                        generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want["sample"] = sequence_sample(spec, _model(spec, weights), sample_data,
                                         seq_len, z_seq=z_seq)

    rng = np.random.default_rng(7)
    arrays = {k: torch.as_tensor(rng.standard_normal((60, v.shape[-1])).astype(np.float32))
              for k, v in batch.items()}
    starts = torch.as_tensor(rng.integers(0, 60 - 16, size=(3, B)).astype(np.int32))

    from lets_face_it_tpu_torch.features import flame_fit as fit
    from lets_face_it_tpu_torch.render.flame import synthetic_flame_model

    targets = (rng.standard_normal((5, 51, 2)) * 40).astype(np.float32)
    fit_steps = dict(stage1_steps=3, stage2_steps=3)
    head = synthetic_flame_model(160, seed=1, device="cpu")
    want["fit"] = fit.fit_batch(head, fit.synthetic_landmark_embedding(head, seed=2),
                                targets, **fit_steps)

    hp_run = port_hp(hp)
    hp_run.lr = 1e-5
    corpus = synthetic_corpus(hp_run, 0, frames_per_chunk=40)
    want["train"] = train(hp_run, seed=3, max_steps=3, device="cpu", corpus=corpus,
                          verbose=False)[1]

    inputs = dict(hp=php, hp_trick=hp_trick, hp_run=hp_run, spec=spec, batch=batch,
                  jax_weights=jax_weights, jax_draws=jax_draws, weights=weights,
                  trick_draws=trick_draws, fresh=fresh, sample_data=sample_data,
                  seq_len=seq_len, z_seq=z_seq, arrays=arrays, starts=starts,
                  targets=targets, fit_steps=fit_steps, corpus=corpus,
                  ckpt_dirs=[str(tmp / f"ck{r}") for r in range(RANKS)])
    return inputs, want


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    inputs, want = _inputs(tmp)
    torch.save(inputs, tmp / "inputs.pt")
    torch.multiprocessing.spawn(_worker, args=(_free_port(), str(tmp / "inputs.pt"),
                                               str(tmp)), nprocs=RANKS)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return ranks, want, inputs


def _assert_params(got, want, atol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


def test_pad_batch():
    batch = {"x": np.arange(10, dtype=np.float32)[:, None]}
    padded, real = pmesh.pad_batch(batch, 8)
    assert real == 10 and padded["x"].shape[0] == 16
    np.testing.assert_array_equal(padded["x"][10:], np.repeat(batch["x"][-1:], 6, axis=0))
    assert pmesh.pad_batch(batch, 5) == (batch, 10)


def test_step_on_two_ranks_matches_the_jax_single_device_step(ddp):
    ranks, want, _ = ddp
    nll, params = want["jax_step"]
    for out in ranks:
        assert out["jax_step"][0] == pytest.approx(nll, rel=1e-5)
        _assert_params(out["jax_step"][1], params, atol=2e-5)


def test_negative_nll_trick_on_two_ranks_matches_one_process(ddp):
    """The deranged step takes its rows from the global batch: the p2
    modalities gathered from both ranks, permuted by the global draw."""
    ranks, want, _ = ddp
    nlls, deranged, params = want["trick"]
    assert deranged == [0.0, 1.0]
    for out in ranks:
        np.testing.assert_allclose(out["trick"][0], nlls, rtol=1e-5)
        assert out["trick"][1] == deranged
        _assert_params(out["trick"][2], params, atol=2e-5)
    _assert_params(ranks[1]["trick"][2], ranks[0]["trick"][2], atol=0)


def test_actnorm_init_on_two_ranks_is_the_global_batch_init(ddp):
    ranks, want, _ = ddp
    for out in ranks:
        for k, v in want["actnorm"].items():
            np.testing.assert_allclose(out["actnorm"][k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=1e-5)


def test_sampling_split_over_ranks_equals_the_whole_batch(ddp):
    ranks, want, _ = ddp
    for out in ranks:
        assert out["sample"].shape == want["sample"].shape
        np.testing.assert_allclose(out["sample"].numpy(), want["sample"].numpy(),
                                   atol=1e-5)


def test_k_steps_on_two_ranks_equal_single_steps(ddp):
    ranks, _, _ = ddp
    for out in ranks:
        (nll_k, params_k), (nll_1, params_1) = out["k_steps"]
        assert nll_k == nll_1
        _assert_params(params_k, params_1, atol=0)


def test_fit_split_over_ranks_equals_the_unsplit_fit(ddp):
    """Five frames over two ranks (the last repeated to six)."""
    ranks, want, _ = ddp
    params, losses, _ = want["fit"]
    for out in ranks:
        got, got_losses, evals = out["fit"]
        assert got_losses.shape == (5,) and all(e > 0 for e in evals)
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), params[k].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(got_losses.numpy(), losses.numpy(),
                                   atol=1e-5, rtol=1e-4)
    for k in params:
        assert torch.equal(ranks[0]["fit"][0][k], ranks[1]["fit"][0][k])


def test_training_on_two_ranks_matches_one_process(ddp):
    """Three steps and a validation: the same best val loss on both ranks
    (rank 0's, broadcast) as in one process; only rank 0 checkpoints."""
    ranks, want, inputs = ddp
    assert ranks[0]["train"] == ranks[1]["train"]
    assert ranks[0]["train"] == pytest.approx(want["train"], rel=1e-5)
    ck0, ck1 = (os.path.isdir(d) and os.listdir(d) for d in inputs["ckpt_dirs"])
    assert ck0 and not ck1


def test_a_hook_stop_on_rank_0_stops_every_rank(ddp):
    ranks, _, _ = ddp
    assert ranks[0]["hook"] == ranks[1]["hook"] == "stopped at 2 on rank 0"

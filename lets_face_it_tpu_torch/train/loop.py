"""The training harness: epochs, validation self-checks, logging,
checkpoints (the port of ``lets_face_it_tpu/train/loop.py``).

Each epoch shuffles the training windows with ``np.random.default_rng([seed,
epoch])``, so a resumed run consumes the data in the order the uninterrupted
run would; the first batch of a fresh run initialises ActNorm. Batches come
from a background thread (``data/prefetch.py``): gathered on the device from
the split cached there (``data/device_cache.py``, ``hp.device_data_cache``),
or gathered on the host into page-locked memory and uploaded; on the card
both run on a side stream that the step waits on. Neither path changes the
data order.

Validation, each ``check_val_every_n_epoch`` epochs and at the end,
reproduces the reference's self-checks (mimicry_logger.py): the val NLL,
free-run generation of the first val batch with the jerk triplet
(``sequence_sample``, the ``seq_rev`` kernel) and a rendered video of it
(``render_client``), the invertibility error (``sequence_invert``, the
``frame_rev`` kernel), the wrong-context probes (``sequence_nll`` on
deranged batches, the ``seq_fwd`` kernel; with ``gap_permutations`` P > 1
the p2 gap under P more permutations too), and the parameter histograms
(``scale_logging``). Then a checkpoint is written. Validation draws from
generators of its own, seeded from (seed, step), so it never moves the
training trajectory.

``replay`` (``train/replay.py``) runs from another run's start and draws:
the initial weights come from the file, each step takes its draws from it,
and each validation's wrong-context probes take its permutations; one step
a call, and anything the file does not hold raises.

Metrics go to stdout as JSON lines, and to TensorBoard (``tensorboardX``) and
Comet where those import. ``hp.stall_timeout_s`` arms a watchdog that exits
the process with code 17 when steps stop (``utils/watchdog.py``).

``hp.terminate_on_nan`` (the CLI's ``--debug_nans``) checks each step's
loss and gradient norm on the host and raises ``FloatingPointError`` at the
first non-finite one; only this mode synchronises every step (every block
of k steps, below).

The trainer's switches of the JAX package (train.py:34-64):
``hp.precision`` 32 or 16 runs the training and its validation at torch's
ambient matmul precision "highest" or "medium" (``utils/precision.py``),
which the kernels follow; ``hp.steps_per_dispatch`` k > 1 runs whole
blocks of k steps as one CUDA graph over the device data cache
(``train/state.py::MultiStep``), the rest of an epoch step by step, with
the data order, validations and checkpoints of k = 1; ``hp.wire_dtype``
"bf16" ships the host-gathered batches' float arrays as bf16 and widens
them on the device; ``profile_dir`` records a ``torch.profiler`` trace of
the first steps.

Across GPUs (``mesh``, ``parallel/mesh.py``; the CLI makes one under
``torchrun``), every rank takes the same epoch order, gathers its slice of
each batch's window starts (from its device cache or on the host) and
steps as ``train/state.py`` says; validation, the checkpoints, the logged
lines and the hooks run on rank 0, whose results and stop decisions (a
hook's exception) are broadcast, so that no rank is left waiting in a
collective the others never reach.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.data.device_cache import make_device_batcher
from lets_face_it_tpu_torch.data.prefetch import (SideStreamTransfer,
                                                  gather_host,
                                                  prefetch_batches, receive)
from lets_face_it_tpu_torch.data.synthetic import dims_for, make_synthetic_corpus
from lets_face_it_tpu_torch.data.windows import WindowDataset
from lets_face_it_tpu_torch.hparams import HParams
from lets_face_it_tpu_torch.model import seqglow
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.parallel.mesh import replicate
from lets_face_it_tpu_torch.train import metrics as train_metrics
from lets_face_it_tpu_torch.train import replay as train_replay
from lets_face_it_tpu_torch.train import state as train_state
from lets_face_it_tpu_torch.train.checkpoint import (CheckpointManager,
                                                     restore_checkpoint)
from lets_face_it_tpu_torch.utils.device import resolve_device
from lets_face_it_tpu_torch.utils.precision import (matmul_precision,
                                                    training_precision)

# Steps a ``profile_dir`` trace records.
PROFILE_STEPS = 5
# With ``Validation.gap_permutations`` P > 1, the validation's p2 gap under
# each of P more permutations (the i-th seeded from (step, i)), as keys
# ``PERM_GAP_KEY + str(i)``.
PERM_GAP_KEY = "mismatched_nll/shuffled_batch/p2/perm_"


class MetricLogger:
    """JSON lines on stdout, always; when ``enabled``, TensorBoard
    (``tensorboardX``) event files in ``log_dir`` (when one is given) and
    Comet (with an API key in ``config.toml``), each where it imports, else
    a warning. Both are imported here, never at module import."""

    def __init__(self, log_dir=None, enabled: bool = True):
        self.writer = None
        self.comet = None
        if not enabled:
            return
        if log_dir is not None:
            try:
                from tensorboardX import SummaryWriter

                Path(log_dir).mkdir(parents=True, exist_ok=True)
                self.writer = SummaryWriter(str(log_dir))
            except Exception as exc:
                print(f"warning: TensorBoard logging disabled ({exc})",
                      file=sys.stderr)
        try:   # Comet when an API key is configured (reference train.py:25-31)
            from lets_face_it_tpu_torch.config import load_config

            comet = load_config()["comet"]
            if comet.get("api_key"):
                import comet_ml

                self.comet = comet_ml.Experiment(
                    api_key=comet["api_key"],
                    project_name=comet.get("project_name", "lets_face_it"))
        except Exception as exc:
            print(f"warning: Comet logging disabled ({exc})", file=sys.stderr)

    def scalars(self, step: int, values: dict):
        clean = {k: float(v) for k, v in values.items()}
        if self.writer is not None:
            for k, v in clean.items():
                self.writer.add_scalar(k, v, step)
        if self.comet is not None:
            self.comet.log_metrics(clean, step=step)
        print(json.dumps({"step": step, **clean}), file=sys.stdout, flush=True)

    def histogram(self, step: int, name: str, values):
        if self.writer is not None:
            self.writer.add_histogram(name, np.asarray(values).ravel(), step)

    def video_url(self, step: int, url: str, name: str = "validation_video"):
        """A rendered validation video in the experiment trackers (the
        reference embeds it as HTML in Comet, mimicry_logger.py:102-112)."""
        if self.writer is not None:
            self.writer.add_text(name, url, step)
        if self.comet is not None:
            self.comet.log_html(
                f"<h3>{name} (step {step})</h3>"
                f'<video src="{url}" controls width="640">'
                f'<a href="{url}">{url}</a></video>')

    def close(self):
        if self.writer is not None:
            self.writer.close()


def check_finite(step: int, metrics: dict) -> None:
    """Raise ``FloatingPointError`` when the step's loss or gradient norm is
    not finite (the reference's ``terminate_on_nan``). With metrics stacked
    [j] for the steps ``step - j + 1 .. step`` of a block, it names the
    first non-finite one."""
    values = torch.stack([metrics["loss"].float().reshape(-1),
                          metrics["grad_norm"].float().reshape(-1)])
    finite = torch.isfinite(values).all(dim=0).tolist()
    if not all(finite):
        i = finite.index(False)
        loss, grad_norm = values[:, i].tolist()
        bad = step - len(finite) + 1 + i
        raise FloatingPointError(f"non-finite training step {bad}: loss {loss}, "
                                 f"grad_norm {grad_norm}")


class StepProfiler:
    """A ``torch.profiler`` trace (host, and the card where there is one)
    of the first ``PROFILE_STEPS`` training steps, written to
    ``directory/trace.json`` (Chrome trace format) when they are done or
    the run ends."""

    def __init__(self, directory, device):
        from torch.profiler import ProfilerActivity, profile

        self.path = Path(directory) / "trace.json"
        self.device = torch.device(device)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def after(self, steps_done: int):
        if self.prof is not None and steps_done >= PROFILE_STEPS:
            self.stop()

    def stop(self):
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None
        print(f"profiler trace written to {self.path}", flush=True)


def scale_histograms(model: SeqGlow) -> dict:
    """The parameter histograms the reference logs (mimicry_logger.py:126-152):
    actnorm scales and biases, and the LU log_s, of every flow step."""
    flow = model.flow
    perm = flow["perm"]
    log_s = perm["log_s"] if "log_s" in perm else torch.zeros(0)
    return {"actnorm_scales": torch.exp(flow["actnorm"]["logs"]).detach().cpu().numpy(),
            "actnorm_bias": flow["actnorm"]["bias"].detach().cpu().numpy(),
            "lu_log_s": log_s.detach().cpu().numpy()}


def load_datasets(hp: HParams, corpus=None):
    """(train, val) window datasets: from ``corpus`` in memory when given,
    else from the HDF5 store ``dataset_root/Data.file_name``."""
    args = (hp.Data, hp.Conditioning)
    if corpus is not None:
        return (WindowDataset.from_chunks(corpus, "train", *args, hp.Train["seq_len"]),
                WindowDataset.from_chunks(corpus, "val", *args,
                                          hp.Validation["seq_len"]))
    data_file = Path(hp.dataset_root) / hp.Data["file_name"]
    return (WindowDataset.from_file(data_file, "train", *args, hp.Train["seq_len"]),
            WindowDataset.from_file(data_file, "val", *args, hp.Validation["seq_len"]))


def synthetic_corpus(hp: HParams, seed: int, **kwargs):
    """The synthetic corpus at the dims ``hp`` reads (``data/synthetic.py``)."""
    return make_synthetic_corpus(seed=seed, dims=dims_for(hp.Data), **kwargs)


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}


def upload(batch: dict, device, wire_bf16: bool = False) -> dict:
    """A host batch on ``device``. With ``wire_bf16`` the float tensors
    cross as bf16 and are widened back to float32 there (the values rounded
    to the bf16 grid, JAX loop.py:276-290); other tensors pass as they are."""
    if not wire_bf16:
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        if v.is_floating_point():
            out[k] = v.to(torch.bfloat16).to(device, non_blocking=True).float()
        else:
            out[k] = v.to(device, non_blocking=True)
    return out


def batch_transfer(ds: WindowDataset, device, dev_batcher=None,
                   wire_bf16: bool = False) -> SideStreamTransfer:
    """Index batch -> batch on ``device``, for the prefetch worker: the
    on-device gather of ``dev_batcher`` when given, else the host gather
    into page-locked memory (on the card) and its upload (as bf16 with
    ``wire_bf16``)."""
    device = torch.device(device)
    if dev_batcher is not None:
        return SideStreamTransfer(dev_batcher.get_batch, device)
    pin = device.type == "cuda"
    return SideStreamTransfer(
        lambda sel: upload(gather_host(ds, sel, pin_memory=pin), device,
                           wire_bf16),
        device)


def _seeded(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % 2**63)


@torch.no_grad()
def run_validation(spec: FlowSpec, hp: HParams, model: SeqGlow,
                   val_ds: WindowDataset, device, step: int, seed: int, *,
                   logger: MetricLogger | None = None, render_client=None,
                   dev_batcher=None, replay=None) -> dict:
    """Val NLL over the whole split (batches in order, the last one ragged),
    then on its first batch: generation, jerk and a rendered video, the
    invertibility error, the wrong-context probes and the parameter
    histograms, as ``hp.Validation`` switches them on. The probes'
    permutations come from ``replay`` (a ``train/replay.py::Replay``) when
    given. Logs to ``logger`` and returns the metrics (floats)."""
    val_cfg = hp.Validation
    total, n_batches, first = 0.0, 0, None
    for sel in val_ds.epoch_index_batches(hp.batch_size, shuffle=False):
        jb = (dev_batcher.get_batch(sel) if dev_batcher is not None
              else to_device(val_ds.get_batch(sel), device))
        z_seq, loss, _ = seqglow.sequence_nll(spec, model, jb)
        total += float(loss)
        n_batches += 1
        if first is None:
            first = (jb, z_seq, loss)
    out = {"val_loss": total / max(n_batches, 1)}
    if first is not None:
        jb, z_seq, loss = first
        start, seq_len = spec.cond.longest_history, val_cfg["seq_len"]
        if val_cfg.get("inference", False):
            generated = seqglow.sequence_sample(
                spec, model, jb, seq_len, eps_std=float(hp.Infer["eps"]),
                generator=_seeded(seed, step, device))
            gt = jb["p1_face"][:, start:seq_len]
            out.update({k: float(v) for k, v in
                        train_metrics.jerk_metrics(gt, generated).items()})
            if render_client is not None and val_cfg.get("render", False):
                try:
                    render_client(generated.cpu().numpy(), gt.cpu().numpy(), step)
                except Exception as exc:  # rendering must never stop training
                    print(f"render failed: {exc}", file=sys.stderr)
        if val_cfg.get("check_invertion", False):
            out["reconstruction/error_percentage"] = float(
                train_metrics.invertibility_error(spec, model, jb, z_seq, loss))
        if val_cfg.get("wrong_context_test", False) and hasattr(hp, "Mismatch"):
            if replay is not None:
                b, t = jb["p1_face"].shape[:2]
                probes = train_metrics.wrong_context_probes(
                    spec, model, jb, loss, hp.Mismatch,
                    permutations=replay.probe_permutations(step, b, t))
            else:
                probes = train_metrics.wrong_context_probes(
                    spec, model, jb, loss, hp.Mismatch,
                    _seeded(seed, step + 1, "cpu"))
            out.update({k: float(v) for k, v in probes.items()})
            n_perms = int(val_cfg.get("gap_permutations", 1) or 1)
            if n_perms > 1:
                p2_only = {"shuffle_batch": {"p2": hp.Mismatch["shuffle_batch"]["p2"]}}
                for i in range(n_perms):
                    gap = train_metrics.wrong_context_probes(
                        spec, model, jb, loss, p2_only, _seeded(step, i, "cpu"))
                    out[f"{PERM_GAP_KEY}{i}"] = float(gap["mismatched_nll/shuffled_batch/p2"])
        if val_cfg.get("scale_logging", False) and logger is not None:
            for name, values in scale_histograms(model).items():
                logger.histogram(step, name, values)
    if logger is not None:
        logger.scalars(step, out)
    return out


def train(hp: HParams, *, seed: int = 1234, ckpt_dir=None, log_dir=None,
          max_steps: int | None = None, device="cuda", corpus=None,
          resume_from=None, render_client=None, log_every: int = 10,
          verbose: bool = True, step_hook=None, val_hook=None,
          profile_dir=None, mesh=None, replay=None):
    """Full training run on ``device``. The data come from ``corpus`` (in
    memory) when given, else from the HDF5 store under ``hp.dataset_root``.
    ``resume_from`` (or ``hp.resume_from_checkpoint``): a checkpoint file, or
    a directory whose newest checkpoint is taken. ``log_dir``: TensorBoard
    directory (none by default; ``hp.logger`` false turns TensorBoard and
    Comet off). ``render_client(generated, gt, step)`` receives
    the validation's generated sequences when ``Validation.render`` is on.
    ``step_hook(step, metrics)`` fires after every step and
    ``val_hook(step, metrics)`` after each validation; either may raise to
    stop the run. ``profile_dir``: a ``torch.profiler`` trace of the first
    ``PROFILE_STEPS`` steps goes there. ``hp.precision`` (32 or 16) sets the
    matmul precision of the run and its validations, restored on return;
    ``hp.steps_per_dispatch`` and ``hp.wire_dtype`` as the module says.
    ``hp.terminate_on_nan`` raises ``FloatingPointError`` at the first step
    whose loss or gradient norm is not finite. ``mesh``: a
    ``parallel.mesh.Mesh``, to train data-parallel with its other ranks
    (``hp.batch_size`` the global batch, a multiple of their number; the
    ranks run on the mesh's devices). ``replay``: a replay file's path (or
    a ``train/replay.py::Replay``) whose initial weights, step draws and
    probe permutations the run takes (one process, one step a call; a
    step, a validation or a shape the file does not hold raises). Returns
    (final TrainState, best val loss), the same on every rank."""
    with matmul_precision(training_precision(hp)):
        return _train(hp, seed=seed, ckpt_dir=ckpt_dir, log_dir=log_dir,
                      max_steps=max_steps, device=device, corpus=corpus,
                      resume_from=resume_from, render_client=render_client,
                      log_every=log_every, verbose=verbose,
                      step_hook=step_hook, val_hook=val_hook,
                      profile_dir=profile_dir, mesh=mesh, replay=replay)


def _on_main(mesh, fn, *args):
    """``fn(*args)`` on rank 0 (every process without a mesh); its result
    and any exception it raises, broadcast, are every rank's."""
    if mesh is None:
        return fn(*args)
    out = err = None
    if mesh.is_main:
        try:
            out = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - re-raised on every rank
            err = exc
    out, err = mesh.broadcast_object((out, err))
    if err is not None:
        raise err
    return out


def _steps_per_dispatch(hp: HParams, dev_batcher, state) -> int:
    """``hp.steps_per_dispatch``, or 1 where the k-step function cannot
    run (said once): without the device data cache, as the JAX loop does,
    or on the card with an optimizer that cannot step inside a graph."""
    k = int(getattr(hp, "steps_per_dispatch", 1) or 1)
    if k <= 1:
        return 1
    if dev_batcher is None:
        print(f"steps_per_dispatch={k} needs the device data cache "
              "(device_data_cache=on, or auto on the card); running one step "
              "per dispatch", flush=True)
        return 1
    if dev_batcher.device.type == "cuda" and not train_state.graph_supported(
            state.optimizer, state.mesh):
        print(f"steps_per_dispatch={k}: {type(state.optimizer).__name__} "
              f"{'over ' + state.mesh.backend + ' ' if state.mesh else ''}"
              "cannot step inside a CUDA graph; running one step per dispatch",
              flush=True)
        return 1
    return k


def _train(hp: HParams, *, seed, ckpt_dir, log_dir, max_steps, device, corpus,
           resume_from, render_client, log_every, verbose, step_hook,
           val_hook, profile_dir, mesh, replay):
    device = resolve_device(device if mesh is None else mesh.device)
    is_main = mesh is None or mesh.is_main
    train_ds, val_ds = load_datasets(hp, corpus)
    spec = FlowSpec.build(hp)
    steps_per_epoch = max(train_ds.num_batches(hp.batch_size, drop_last=True), 1)
    if replay is not None:
        replay = train_replay.open_replay(replay)
        if mesh is not None:
            raise ValueError("a replayed run trains in one process")
        if int(getattr(hp, "steps_per_dispatch", 1) or 1) > 1:
            raise ValueError("a replayed run takes one step a call: "
                             "steps_per_dispatch must be 1")
        replay.check(spec, hp, hp.batch_size,
                     train_ds.seq_len - spec.cond.longest_history, seed)
        model = replay.model(spec).to(device)
    else:
        model = SeqGlow.init(spec, torch.Generator().manual_seed(seed)).to(device)
    state = train_state.TrainState.create(model, hp, steps_per_epoch, seed,
                                          mesh=mesh)
    if mesh is not None:
        mesh.rows(hp.batch_size)     # the global batch splits evenly
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir and is_main else None

    actnorm_inited, start_epoch, skip = False, 0, 0
    resume_from = resume_from or getattr(hp, "resume_from_checkpoint", None)
    if resume_from:
        path = Path(resume_from)
        if path.is_dir():
            path = CheckpointManager(path).latest()
            if path is None:
                raise FileNotFoundError(f"no checkpoint under {resume_from}")
        meta = restore_checkpoint(path, state)
        if mesh is not None:   # every rank read the file; rank 0's is the state
            replicate(mesh, state.model, state.optimizer)
        actnorm_inited = bool(meta["actnorm_inited"])
        start_epoch, skip = int(meta["epoch"]), int(meta["epoch_step"])
        if skip >= steps_per_epoch:
            start_epoch, skip = start_epoch + 1, 0

    dev_batcher = make_device_batcher(train_ds, hp, device)
    # the val split's auto budget is what the train split left over
    val_batcher = (make_device_batcher(val_ds, hp, device,
                                       reserved_bytes=dev_batcher.total_bytes)
                   if dev_batcher is not None else None)
    wire_bf16 = str(getattr(hp, "wire_dtype", "f32") or "f32") == "bf16"
    transfer = batch_transfer(train_ds, device, dev_batcher, wire_bf16)
    k_dispatch = _steps_per_dispatch(hp, dev_batcher, state)
    multi = None
    if k_dispatch > 1:
        multi = train_state.MultiStep(spec, hp, state, dev_batcher.arrays,
                                      train_ds.seq_len, hp.batch_size,
                                      k_dispatch)
        transfer = SideStreamTransfer(dev_batcher.get_starts_block, device)
    # logged every log_every steps, or every ceil(log_every / k) blocks
    log_blocks = max(1, -(-log_every // k_dispatch))

    logger = MetricLogger(log_dir, enabled=is_main
                          and bool(getattr(hp, "logger", True)))
    if render_client is not None and getattr(render_client, "on_rendered",
                                             None) is None:
        render_client.on_rendered = logger.video_url
    watchdog = None
    if getattr(hp, "stall_timeout_s", None):
        from lets_face_it_tpu_torch.utils.watchdog import ProgressWatchdog

        watchdog = ProgressWatchdog(float(hp.stall_timeout_s))
    profiler = StepProfiler(profile_dir, device) if profile_dir else None

    terminate_on_nan = bool(getattr(hp, "terminate_on_nan", False))
    best_val = float("inf")
    max_epochs = int(hp.max_epochs or 1)
    val_every = int(getattr(hp, "check_val_every_n_epoch", 1) or 1)
    start_step, t_start = state.step, time.perf_counter()
    done = max_steps is not None and state.step >= max_steps

    def log(m):
        if not is_main:
            return
        m = {k: float(v) for k, v in m.items()}
        m["train_loss"] = m.pop("loss")
        m["steps_per_sec"] = ((state.step - start_step)
                              / (time.perf_counter() - t_start))
        logger.scalars(state.step, m)

    try:
        for epoch in range(start_epoch, max_epochs):
            if done:
                break
            np_rng = np.random.default_rng([seed, epoch])
            sels = list(train_ds.epoch_index_batches(hp.batch_size, rng=np_rng,
                                                     shuffle=True, drop_last=True))
            if max_steps is not None:
                sels = sels[:skip + max_steps - state.step]
            epoch_step = skip
            todo = sels[skip:]
            if mesh is not None:   # this rank's rows of every batch
                todo = [mesh.local(sel) for sel in todo]
            if multi is not None:
                if not actnorm_inited and todo:
                    # the first block's first batch, gathered once more here
                    train_state.run_actnorm_init(
                        spec, state, dev_batcher.get_batch(todo[0]))
                    actnorm_inited = True
                # whole blocks of k steps, then the rest as one short block
                todo = [todo[i:i + k_dispatch]
                        for i in range(0, len(todo), k_dispatch)]
            for n_items, staged in enumerate(
                    prefetch_batches(iter(todo), transfer=transfer), 1):
                jb = receive(staged)
                if multi is not None:
                    m = multi(jb["starts"])
                    j = int(jb["starts"].shape[0])
                else:
                    if not actnorm_inited:
                        train_state.run_actnorm_init(spec, state, jb)
                        actnorm_inited = True
                    m = train_state.train_step(
                        spec, hp, state, jb,
                        draws=(replay.draws(state.step) if replay is not None
                               else None))
                    j = 1
                if terminate_on_nan:
                    check_finite(state.step, m)
                epoch_step += j
                if watchdog is not None:
                    watchdog.beat()
                if profiler is not None:
                    profiler.after(state.step - start_step)
                done = max_steps is not None and state.step >= max_steps
                if step_hook is not None:
                    for i in range(j):
                        _on_main(mesh, step_hook, state.step - j + 1 + i,
                                 {key: v[i] for key, v in m.items()}
                                 if multi is not None else m)
                if verbose and (done or (state.step % log_every == 0
                                         if multi is None
                                         else n_items % log_blocks == 0)):
                    log({key: v[-1] for key, v in m.items()}
                        if multi is not None else m)
                if done:
                    break
            skip = 0
            if (epoch + 1) % val_every == 0 or done:
                out = _on_main(mesh, lambda: run_validation(
                    spec, hp, state.model, val_ds, device, state.step, seed,
                    logger=logger, render_client=render_client,
                    dev_batcher=val_batcher, replay=replay))
                best_val = min(best_val, out["val_loss"])
                if val_hook is not None:
                    _on_main(mesh, val_hook, state.step, out)
                if ckpt is not None:
                    ckpt.save(state, hp, epoch=epoch, epoch_step=epoch_step,
                              actnorm_inited=actnorm_inited,
                              val_loss=out["val_loss"])
                if watchdog is not None:
                    watchdog.beat()   # validation and checkpointing took a while
    finally:
        # an armed watchdog left behind by an exception would os._exit(17)
        # the process minutes later, in whatever the caller does next
        if watchdog is not None:
            watchdog.stop()
        if profiler is not None:
            profiler.stop()
        logger.close()
    return state, best_val

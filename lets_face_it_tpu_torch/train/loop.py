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
deranged batches, the ``seq_fwd`` kernel), and the parameter histograms
(``scale_logging``). Then a checkpoint is written. Validation draws from
generators of its own, seeded from (seed, step), so it never moves the
training trajectory.

Metrics go to stdout as JSON lines, and to TensorBoard (``tensorboardX``) and
Comet where those import. ``hp.stall_timeout_s`` arms a watchdog that exits
the process with code 17 when steps stop (``utils/watchdog.py``).

Left out, as in ``ROADMAP.md``: k steps per dispatch and the bf16 wire
format.
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
from lets_face_it_tpu_torch.train import metrics as train_metrics
from lets_face_it_tpu_torch.train import state as train_state
from lets_face_it_tpu_torch.train.checkpoint import (CheckpointManager,
                                                     restore_checkpoint)
from lets_face_it_tpu_torch.utils.device import resolve_device


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


def batch_transfer(ds: WindowDataset, device, dev_batcher=None) -> SideStreamTransfer:
    """Index batch -> batch on ``device``, for the prefetch worker: the
    on-device gather of ``dev_batcher`` when given, else the host gather
    into page-locked memory (on the card) and its upload."""
    device = torch.device(device)
    if dev_batcher is not None:
        return SideStreamTransfer(dev_batcher.get_batch, device)
    pin = device.type == "cuda"
    return SideStreamTransfer(
        lambda sel: {k: v.to(device, non_blocking=True)
                     for k, v in gather_host(ds, sel, pin_memory=pin).items()},
        device)


def _seeded(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + step) % 2**63)


@torch.no_grad()
def run_validation(spec: FlowSpec, hp: HParams, model: SeqGlow,
                   val_ds: WindowDataset, device, step: int, seed: int, *,
                   logger: MetricLogger | None = None, render_client=None,
                   dev_batcher=None) -> dict:
    """Val NLL over the whole split (batches in order, the last one ragged),
    then on its first batch: generation, jerk and a rendered video, the
    invertibility error, the wrong-context probes and the parameter
    histograms, as ``hp.Validation`` switches them on. Logs to ``logger``
    and returns the metrics (floats)."""
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
            probes = train_metrics.wrong_context_probes(
                spec, model, jb, loss, hp.Mismatch, _seeded(seed, step + 1, "cpu"))
            out.update({k: float(v) for k, v in probes.items()})
        if val_cfg.get("scale_logging", False) and logger is not None:
            for name, values in scale_histograms(model).items():
                logger.histogram(step, name, values)
    if logger is not None:
        logger.scalars(step, out)
    return out


def train(hp: HParams, *, seed: int = 1234, ckpt_dir=None, log_dir=None,
          max_steps: int | None = None, device="cuda", corpus=None,
          resume_from=None, render_client=None, log_every: int = 10,
          verbose: bool = True, step_hook=None, val_hook=None):
    """Full training run on ``device``. The data come from ``corpus`` (in
    memory) when given, else from the HDF5 store under ``hp.dataset_root``.
    ``resume_from`` (or ``hp.resume_from_checkpoint``): a checkpoint file, or
    a directory whose newest checkpoint is taken. ``log_dir``: TensorBoard
    directory (none by default; ``hp.logger`` false turns TensorBoard and
    Comet off). ``render_client(generated, gt, step)`` receives
    the validation's generated sequences when ``Validation.render`` is on.
    ``step_hook(step, metrics)`` fires after every step and
    ``val_hook(step, metrics)`` after each validation; either may raise to
    stop the run. Returns (final TrainState, best val loss)."""
    device = resolve_device(device)
    train_ds, val_ds = load_datasets(hp, corpus)
    spec = FlowSpec.build(hp)
    steps_per_epoch = max(train_ds.num_batches(hp.batch_size, drop_last=True), 1)
    model = SeqGlow.init(spec, torch.Generator().manual_seed(seed)).to(device)
    state = train_state.TrainState.create(model, hp, steps_per_epoch, seed)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None

    actnorm_inited, start_epoch, skip = False, 0, 0
    resume_from = resume_from or getattr(hp, "resume_from_checkpoint", None)
    if resume_from:
        path = Path(resume_from)
        if path.is_dir():
            path = CheckpointManager(path).latest()
            if path is None:
                raise FileNotFoundError(f"no checkpoint under {resume_from}")
        meta = restore_checkpoint(path, state)
        actnorm_inited = bool(meta["actnorm_inited"])
        start_epoch, skip = int(meta["epoch"]), int(meta["epoch_step"])
        if skip >= steps_per_epoch:
            start_epoch, skip = start_epoch + 1, 0

    dev_batcher = make_device_batcher(train_ds, hp, device)
    # the val split's auto budget is what the train split left over
    val_batcher = (make_device_batcher(val_ds, hp, device,
                                       reserved_bytes=dev_batcher.total_bytes)
                   if dev_batcher is not None else None)
    transfer = batch_transfer(train_ds, device, dev_batcher)

    logger = MetricLogger(log_dir, enabled=bool(getattr(hp, "logger", True)))
    if render_client is not None and getattr(render_client, "on_rendered",
                                             None) is None:
        render_client.on_rendered = logger.video_url
    watchdog = None
    if getattr(hp, "stall_timeout_s", None):
        from lets_face_it_tpu_torch.utils.watchdog import ProgressWatchdog

        watchdog = ProgressWatchdog(float(hp.stall_timeout_s))

    best_val = float("inf")
    max_epochs = int(hp.max_epochs or 1)
    val_every = int(getattr(hp, "check_val_every_n_epoch", 1) or 1)
    start_step, t_start = state.step, time.perf_counter()
    done = max_steps is not None and state.step >= max_steps
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
            for staged in prefetch_batches(iter(sels[skip:]), transfer=transfer):
                jb = receive(staged)
                if not actnorm_inited:
                    train_state.run_actnorm_init(spec, state, jb)
                    actnorm_inited = True
                m = train_state.train_step(spec, hp, state, jb)
                epoch_step += 1
                if watchdog is not None:
                    watchdog.beat()
                done = max_steps is not None and state.step >= max_steps
                if step_hook is not None:
                    step_hook(state.step, m)
                if verbose and (state.step % log_every == 0 or done):
                    m = {k: float(v) for k, v in m.items()}
                    m["train_loss"] = m.pop("loss")
                    m["steps_per_sec"] = ((state.step - start_step)
                                          / (time.perf_counter() - t_start))
                    logger.scalars(state.step, m)
                if done:
                    break
            skip = 0
            if (epoch + 1) % val_every == 0 or done:
                out = run_validation(spec, hp, state.model, val_ds, device,
                                     state.step, seed, logger=logger,
                                     render_client=render_client,
                                     dev_batcher=val_batcher)
                best_val = min(best_val, out["val_loss"])
                if val_hook is not None:
                    val_hook(state.step, out)
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
        logger.close()
    return state, best_val

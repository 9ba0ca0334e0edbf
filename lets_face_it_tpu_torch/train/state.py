"""Train state and the training step (the port of
``lets_face_it_tpu/train/state.py``).

One step (reference lets_face_it_glow.py:39-54, JAX train/state.py:79-112):

(a) a coin, a batch permutation and the encoders' frame-dropout masks are
    drawn on every step, from the state's generator unless a caller hands
    them in (``StepDraws``; the tests replay the JAX package's draws);
(b) with the negative-NLL trick configured, the deranged batch (the p2
    modalities permuted across the batch) is used when
    ``coin < 0.1 and last_mismatched_nll > 0``, and the loss factor is then
    -0.1 (gradient ascent on mismatched conditioning);
(c) after such a step ``last_mismatched_nll`` becomes -nll;
(d) the gradient norm is taken over the trained parameters (the frozen
    invconv P and sign(s) have none, as the JAX package masks theirs to
    zero) before global-norm clipping; then the optimizer steps at the
    learning rate of ``step // steps_per_epoch``.

The generator is a CPU ``torch.Generator``: the draws, and so the whole
trajectory, do not depend on the device the model runs on. ActNorm's
data-dependent init runs once on the first batch (``run_actnorm_init``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from lets_face_it_tpu_torch.model import flow, seqglow
from lets_face_it_tpu_torch.model.encoders import encode_conditioning
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.train import derange
from lets_face_it_tpu_torch.train.optim import (LRSchedule, build_optimizer,
                                                clip_by_global_norm)


@dataclass
class StepDraws:
    """The random numbers of one step: the coin, the batch permutation [B]
    and the frame-dropout masks {modality: [B, N, h]}."""
    coin: float
    perm: torch.Tensor
    dropout_masks: dict | None = None


@dataclass
class TrainState:
    model: SeqGlow
    optimizer: torch.optim.Optimizer
    schedule: LRSchedule
    generator: torch.Generator
    step: int = 0
    last_mismatched_nll: float = math.inf
    trained: list = field(default_factory=list)

    @classmethod
    def create(cls, model: SeqGlow, hp, steps_per_epoch: int,
               seed: int) -> "TrainState":
        """Optimizer over the model's trained parameters, the schedule, and
        the step generator seeded with ``seed``."""
        trained = [p for p in model.parameters() if p.requires_grad]
        return cls(model=model, optimizer=build_optimizer(hp, trained),
                   schedule=LRSchedule(hp, steps_per_epoch),
                   generator=torch.Generator().manual_seed(seed),
                   trained=trained)


@torch.no_grad()
def run_actnorm_init(spec: FlowSpec, state: TrainState, batch) -> None:
    """Data-dependent actnorm init from the batch's first conditioned frame
    (no dropout), written into the model in place."""
    x = batch["p1_face"]
    start = spec.cond.longest_history
    times = torch.arange(start, start + 1, device=x.device)
    cond = encode_conditioning(spec.cond, state.model.encoder, batch, x, times)
    an = flow.actnorm_sequential_init(spec, state.model.flow, x[:, start],
                                      cond[:, 0])
    for name, value in an.items():
        state.model.flow["actnorm"][name].copy_(value)


def draw_step(spec: FlowSpec, state: TrainState, batch_size: int) -> StepDraws:
    """The coin and the permutation from the state's generator; the dropout
    masks are drawn later, by the encoders, from the same generator."""
    coin = float(torch.rand((), generator=state.generator))
    perm = torch.randperm(batch_size, generator=state.generator)
    return StepDraws(coin, perm)


def train_step(spec: FlowSpec, hp, state: TrainState, batch, *,
               draws: StepDraws | None = None) -> dict:
    """One optimizer step on ``batch`` (tensors on the model's device);
    updates ``state`` in place and returns the step's metrics as tensors
    (loss, nll, deranged, grad_norm)."""
    use_negative = bool(hp.Train.get("use_negative_nll_loss", False))
    neg_modalities, _ = derange.mismatched_modalities(hp.Conditioning)
    if draws is None:
        draws = draw_step(spec, state, batch["p1_face"].shape[0])
    use_deranged = (use_negative and bool(neg_modalities) and draws.coin < 0.1
                    and state.last_mismatched_nll > 0)
    deranged = derange.derange_batch(batch, neg_modalities, perm=draws.perm)
    chosen = derange.select_batch(use_deranged, deranged, batch)
    factor = -0.1 if use_deranged else 1.0

    _, nll, _ = seqglow.sequence_nll(
        spec, state.model, chosen, training=True, generator=state.generator,
        dropout_masks=draws.dropout_masks)
    loss = factor * nll
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grads = [p.grad for p in state.trained if p.grad is not None]
    clip = float(getattr(hp, "gradient_clip_val", 0.0) or 0.0)
    grad_norm = clip_by_global_norm(grads, clip)
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()

    if use_deranged:
        state.last_mismatched_nll = -nll.item()
    state.step += 1
    return {"loss": loss.detach(), "nll": nll.detach(),
            "deranged": torch.tensor(float(use_deranged)),
            "grad_norm": grad_norm}

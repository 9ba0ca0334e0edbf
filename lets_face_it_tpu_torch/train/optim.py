"""Optimizers, the epoch learning-rate table and global-norm clipping (the
port of ``lets_face_it_tpu/train/optim.py``, which builds them from optax;
reference lets_face_it_glow.py:61-72, glow/utils.py:65-82).

* ``epoch_lr_table``: the learning rate of each epoch under the "step",
  "multiplicative" or "lambda" schedule; the step's rate is looked up by
  ``step // steps_per_epoch`` at the count before the update, as optax does.
* ``build_optimizer``: Adam (``torch.optim.Adam`` computes optax's update,
  ``lr * m_hat / (sqrt(v_hat) + eps)``), SGD with momentum (the same trace
  as optax's), and RMSprop in optax's form (decay 0.9,
  ``g / sqrt(nu + eps)``, which ``torch.optim.RMSprop`` does not compute).
* ``clip_by_global_norm``: optax's form: the gradients are scaled by
  ``max_norm / norm`` only when ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and differs).
"""

from __future__ import annotations

import numpy as np
import torch


def epoch_lr_table(hp, n_epochs: int) -> np.ndarray:
    """lr value for each epoch 0..n_epochs-1 under the configured schedule."""
    base_lr = float(hp.lr)
    sched = hp.Optim.get("Schedule", {}) or {}
    name = sched.get("name")
    lrs = np.full(max(n_epochs, 1), base_lr, np.float64)
    if not name:
        return lrs
    args = sched["args"][name]
    if name == "step":
        gamma, size = float(args["gamma"]), int(args["step_size"])
        for e in range(n_epochs):
            lrs[e] = base_lr * gamma ** (e // size)
    elif name == "multiplicative":
        val = int(args["val"])
        lr = base_lr
        for e in range(n_epochs):
            if e > 0:
                lr *= e // val
            lrs[e] = lr
    elif name == "lambda":
        val = int(args["val"])
        for e in range(n_epochs):
            lrs[e] = base_lr * (e // val)
    else:
        raise NotImplementedError(f"scheduler {name!r}")
    return lrs


class LRSchedule:
    """Per-step learning rate: the epoch table looked up by
    ``step // steps_per_epoch`` (clamped to the last epoch), float32 as
    optax's table is."""

    def __init__(self, hp, steps_per_epoch: int):
        n_epochs = int(getattr(hp, "max_epochs", 30) or 30)
        self.table = epoch_lr_table(hp, n_epochs).astype(np.float32)
        self.steps_per_epoch = max(int(steps_per_epoch), 1)

    def __call__(self, step: int) -> float:
        epoch = min(step // self.steps_per_epoch, len(self.table) - 1)
        return float(self.table[epoch])


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay=0.9, eps): nu = decay nu + (1 - decay) g^2;
    p -= lr * g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1.0 - group["decay"])
                p.sub_(group["lr"] * p.grad / torch.sqrt(nu + group["eps"]))


def build_optimizer(hp, params) -> torch.optim.Optimizer:
    """The configured optimizer over ``params``; its learning rate is set
    before each step from ``LRSchedule``."""
    name = hp.Optim["name"]
    args = hp.Optim["args"].get(name, {}) or {}
    lr = float(hp.lr)
    if name == "adam":
        betas = tuple(args.get("betas", (0.9, 0.999)))
        return torch.optim.Adam(params, lr=lr, betas=betas,
                                eps=float(args.get("eps", 1e-8)))
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(args.get("momentum", 0.0)))
    if name == "rmsprop":
        return OptaxRMSprop(params, lr=lr, eps=float(args.get("eps", 1e-8)))
    raise NotImplementedError(f"optimizer {name!r}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of all entries (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when ``norm >=
    max_norm`` (optax.clip_by_global_norm); returns the norm before
    clipping."""
    norm = global_norm(grads)
    if max_norm > 0:
        clip = norm >= max_norm
        for g in grads:
            g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm

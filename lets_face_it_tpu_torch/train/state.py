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

Steps (b)-(d) are one function, ``apply_step``, with the branch of (b) a
select on the device and no host sync. ``train_step`` runs it once on a
batch; ``MultiStep`` runs it k times per call over the device data cache
(the counterpart of the JAX package's ``make_multi_train_step``): each
batch is gathered inside it from a [k, B] block of window starts, and the
draws of the k steps are taken ahead from the same generator in the order
k single steps take them. On the card the k steps are one CUDA graph,
captured once and replayed for every full block; elsewhere, and for a
block shorter than k, they run step by step.

Across GPUs (``parallel/mesh.py``, ``TrainState.mesh``), each rank steps on
its rows of the global batch: the draws are those of the global batch,
taken the same on every rank and sliced (the deranged rows gathered from
the ranks that hold them), the NLL that the metrics and the trick read is
the global mean, the gradients are averaged by one all-reduce, and ActNorm
is initialised from the global batch's first frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from lets_face_it_tpu_torch.data.device_cache import gather_windows
from lets_face_it_tpu_torch.model import flow, seqglow
from lets_face_it_tpu_torch.model.encoders import (dropout_mask_shapes,
                                                   encode_conditioning,
                                                   frame_dropout_mask)
from lets_face_it_tpu_torch.ops import flow_kernels, train_kernels
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.parallel.mesh import Mesh, replicate
from lets_face_it_tpu_torch.train import derange
from lets_face_it_tpu_torch.train.optim import (LRSchedule, OptaxRMSprop,
                                                build_optimizer,
                                                clip_by_global_norm)


@dataclass
class StepDraws:
    """The random numbers of one step: the coin, the batch permutation [B]
    and the frame-dropout keep-masks {modality: [B, N, h]}."""
    coin: float
    perm: torch.Tensor
    dropout_masks: dict


@dataclass
class TrainState:
    model: SeqGlow
    optimizer: torch.optim.Optimizer
    schedule: LRSchedule
    generator: torch.Generator
    step: int = 0
    last_mismatched_nll: float = math.inf
    trained: list = field(default_factory=list)
    mesh: Mesh | None = None

    @classmethod
    def create(cls, model: SeqGlow, hp, steps_per_epoch: int,
               seed: int, mesh: Mesh | None = None) -> "TrainState":
        """Optimizer over the model's trained parameters, the schedule, and
        the step generator seeded with ``seed``; with a ``mesh``, rank 0's
        model on every rank."""
        if mesh is not None:
            replicate(mesh, model)
        trained = [p for p in model.parameters() if p.requires_grad]
        return cls(model=model, optimizer=build_optimizer(hp, trained),
                   schedule=LRSchedule(hp, steps_per_epoch),
                   generator=torch.Generator().manual_seed(seed),
                   trained=trained, mesh=mesh)

    def global_batch(self, local: int) -> int:
        """The global batch of ``local`` rows a rank."""
        return local * (self.mesh.size if self.mesh is not None else 1)


@torch.no_grad()
def run_actnorm_init(spec: FlowSpec, state: TrainState, batch) -> None:
    """Data-dependent actnorm init from the batch's first conditioned frame
    (no dropout), written into the model in place; with a mesh, from the
    global batch's (gathered from every rank)."""
    x = batch["p1_face"]
    start = spec.cond.longest_history
    times = torch.arange(start, start + 1, device=x.device)
    cond = encode_conditioning(spec.cond, state.model.encoder, batch, x, times)
    x0, cond0 = x[:, start], cond[:, 0]
    if state.mesh is not None:
        x0, cond0 = state.mesh.all_gather(x0), state.mesh.all_gather(cond0)
    an = flow.actnorm_sequential_init(spec, state.model.flow, x0, cond0)
    for name, value in an.items():
        state.model.flow["actnorm"][name].copy_(value)


def draw_step(spec: FlowSpec, state: TrainState, batch_size: int,
              n_frames: int) -> StepDraws:
    """The coin, the permutation and the dropout masks of one step from the
    state's generator, in the order the encoders would draw the masks."""
    gen = state.generator
    coin = float(torch.rand((), generator=gen))
    perm = torch.randperm(batch_size, generator=gen)
    masks = {name: frame_dropout_mask(getattr(spec.cond, name), shape, gen)
             for name, shape in dropout_mask_shapes(spec.cond, batch_size,
                                                    n_frames).items()}
    return StepDraws(coin, perm, masks)


def apply_step(spec: FlowSpec, hp, state: TrainState, batch, coin, perm,
               masks: dict, lr, last):
    """Steps (b)-(d) on ``batch`` given the draws (``coin`` a number or a
    device scalar, ``perm`` and ``masks`` on the batch's device), the
    learning rate ``lr`` (a number or a device scalar) and
    ``last_mismatched_nll`` as a device scalar ``last``: no host sync and no
    host branch on a device value, so that a CUDA graph can hold it.
    With ``state.mesh``, ``batch`` is this rank's rows and the draws the
    global batch's. -> (the step's metrics, the next ``last``), as device
    tensors."""
    mesh = state.mesh
    if mesh is not None:
        masks = {name: mesh.local(m) for name, m in masks.items()}
    use = torch.zeros((), dtype=torch.bool, device=last.device)
    neg_modalities, _ = derange.mismatched_modalities(hp.Conditioning)
    if hp.Train.get("use_negative_nll_loss", False) and neg_modalities:
        use = (coin < 0.1) & (last > 0)

        def deranged(x):
            if mesh is None:
                return x[perm]
            return mesh.local(mesh.all_gather(x)[perm])

        batch = {name: (torch.where(use, deranged(x), x)
                        if name in neg_modalities else x)
                 for name, x in batch.items()}
    _, nll, _ = seqglow.sequence_nll(spec, state.model, batch, training=True,
                                     dropout_masks=masks)
    factor = torch.where(use, -0.1, 1.0)
    for p in state.trained:
        if p.grad is not None:
            p.grad.zero_()
    (factor * nll).backward()
    grads = [p.grad for p in state.trained if p.grad is not None]
    nll = nll.detach()
    if mesh is not None:
        # the global batch's mean (the shards are equal) and its gradient
        nll = mesh.all_reduce_mean(nll.clone())
        mesh.average_gradients(grads)
    loss = factor * nll
    clip = float(getattr(hp, "gradient_clip_val", 0.0) or 0.0)
    grad_norm = clip_by_global_norm(grads, clip)
    for group in state.optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)
    state.optimizer.step()
    metrics = {"loss": loss, "nll": nll, "deranged": use.float(),
               "grad_norm": grad_norm}
    return metrics, torch.where(use, -nll, last)


def upload(x, device):
    """A host tensor on ``device`` in stream order: on the card from
    page-locked memory without waiting for the card (the host allocator
    keeps the block until the copy has run)."""
    if device.type == "cuda":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def train_step(spec: FlowSpec, hp, state: TrainState, batch, *,
               draws: StepDraws | None = None) -> dict:
    """One optimizer step on ``batch`` (tensors on the model's device);
    updates ``state`` in place (``last_mismatched_nll`` becomes a device
    scalar) and returns the step's metrics as device tensors (loss, nll,
    deranged, grad_norm), with no host sync."""
    x = batch["p1_face"]
    dev = x.device
    if draws is None:
        draws = draw_step(spec, state, state.global_batch(x.shape[0]),
                          x.shape[1] - spec.cond.longest_history)
    last = state.last_mismatched_nll
    if not torch.is_tensor(last):
        last = torch.full((), float(last), device=dev)
    metrics, state.last_mismatched_nll = apply_step(
        spec, hp, state, batch, draws.coin, upload(draws.perm, dev),
        {name: upload(m, dev) for name, m in draws.dropout_masks.items()},
        state.schedule(state.step), last)
    state.step += 1
    return metrics


# The kernel wrappers whose ``launches`` a replayed graph adds to: their
# counters count on the host, where a capture runs them once and a replay
# not at all.
_KERNELS = (train_kernels.cond_gates, train_kernels.seq_fwd,
            train_kernels.seq_bwd, flow_kernels.frame_rev_fused,
            flow_kernels.sequence_rev_fused, flow_kernels.sample_gates,
            flow_kernels.sample_chain)


def _counters(f) -> dict:
    """A kernel wrapper's launch counters: the total (key None) and, where
    it counts them, its launches by plan."""
    return {None: f.launches, **getattr(f, "plans", {})}


def _add_counters(f, counts: dict) -> None:
    for key, n in counts.items():
        if key is None:
            f.launches += n
        else:
            f.plans[key] += n


def graph_supported(optimizer: torch.optim.Optimizer,
                    mesh: Mesh | None = None) -> bool:
    """Whether ``optimizer`` can step inside a CUDA graph with its learning
    rate in a device tensor: Adam (``capturable``) and the optax-form
    RMSprop; torch's SGD reads its rate on the host. Across GPUs the
    collectives must be NCCL's (gloo's cannot be captured)."""
    return (isinstance(optimizer, (torch.optim.Adam, OptaxRMSprop))
            and (mesh is None or mesh.backend == "nccl"))


class MultiStep:
    """k optimizer steps per call on the batches of a [k, B] block of window
    starts, gathered from ``arrays`` (the device data cache's
    ``{modality: [T, D]}``), each step ``apply_step``.

    Per call, the host takes the k steps' draws (coin, permutation,
    frame-dropout masks; the global batch's under a mesh, whose ``arrays``
    gather this rank's rows) from ``state.generator`` in the order k calls of
    ``train_step`` take them, and the k learning rates, and copies them into
    fixed device buffers. On the card the first full block runs eagerly on
    a side stream (the warm-up a capture needs), the second is captured as
    one CUDA graph, and every full block replays it; a replay adds the
    kernels' launches of one block to their counters. Adam becomes
    ``capturable`` with its rate in a device tensor. Returns the steps'
    metrics stacked [j] per key, as tensors, with no host sync;
    ``state.last_mismatched_nll`` is then a device scalar. ``replays``
    counts the graph's replays in this process."""

    replays = 0

    def __init__(self, spec: FlowSpec, hp, state: TrainState, arrays: dict,
                 seq_len: int, batch_size: int, k: int):
        self.spec, self.hp, self.state, self.k = spec, hp, state, int(k)
        self.arrays, self.seq_len, self.b = arrays, int(seq_len), int(batch_size)
        self.device = next(iter(arrays.values())).device
        self.n_frames = self.seq_len - spec.cond.longest_history
        mask_shapes = dropout_mask_shapes(spec.cond, self.b, self.n_frames)
        dev, k = self.device, self.k
        local = self.b // (state.mesh.size if state.mesh is not None else 1)
        self.starts = torch.zeros((k, local), dtype=torch.int32, device=dev)
        self.coins = torch.zeros(k, device=dev)
        self.perms = torch.zeros((k, self.b), dtype=torch.int64, device=dev)
        self.masks = {name: torch.zeros((k,) + shape, device=dev)
                      for name, shape in mask_shapes.items()}
        self.lrs = torch.zeros(k, device=dev)
        self.last = torch.zeros((), device=dev)
        self.out = {key: torch.zeros(k, device=dev)
                    for key in ("loss", "nll", "deranged", "grad_norm")}
        self.on_card = dev.type == "cuda"
        if self.on_card:
            if not graph_supported(state.optimizer, state.mesh):
                raise ValueError(f"{type(state.optimizer).__name__} cannot step "
                                 "inside a CUDA graph here")
            lr = torch.zeros((), device=dev)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
                if "capturable" in group:
                    group["capturable"] = True
            for st in state.optimizer.state.values():
                if "step" in st:
                    st["step"] = st["step"].to(dev, torch.float32)
        self.graph, self.warm, self.graph_launches = None, False, {}
        self.stream = torch.cuda.Stream(dev) if self.on_card else None

    def _draw(self, j: int) -> None:
        """The draws and rates of the next j steps into the fixed buffers."""
        st = self.state
        draws = [draw_step(self.spec, st, self.b, self.n_frames)
                 for _ in range(j)]
        self._upload(self.coins[:j], torch.tensor([d.coin for d in draws],
                                                  dtype=torch.float32))
        self._upload(self.perms[:j], torch.stack([d.perm for d in draws]))
        for name, buf in self.masks.items():
            self._upload(buf[:j], torch.stack(
                [d.dropout_masks[name] for d in draws]).float())
        self._upload(self.lrs[:j], torch.tensor(
            [st.schedule(st.step + i) for i in range(j)], dtype=torch.float32))
        last = st.last_mismatched_nll
        if last is not self.last:
            self.last.fill_(float(last))

    def _upload(self, dst, src) -> None:
        """``src`` (host) into the fixed buffer ``dst`` as ``upload`` moves
        it, so that the host draws the next block while the card runs this
        one."""
        if self.on_card:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=self.on_card)

    def _body(self, i: int) -> None:
        """Step i of the block (``apply_step``), from the fixed buffers into
        them."""
        batch = gather_windows(self.arrays, self.starts[i], self.seq_len)
        metrics, last = apply_step(
            self.spec, self.hp, self.state, batch, self.coins[i], self.perms[i],
            {name: m[i] for name, m in self.masks.items()}, self.lrs[i],
            self.last)
        self.last.copy_(last)
        for key, v in metrics.items():
            self.out[key][i].copy_(v)

    def _eager(self, j: int) -> None:
        for i in range(j):
            self._body(i)

    def _capture(self) -> None:
        before = {f: _counters(f) for f in _KERNELS}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            self._eager(self.k)
        self.graph_launches = {f: {key: n - before[f][key]
                                   for key, n in _counters(f).items()}
                               for f in _KERNELS}
        for f in _KERNELS:   # a capture runs nothing
            _add_counters(f, {key: -n for key, n in self.graph_launches[f].items()})

    def __call__(self, starts) -> dict:
        """Run the steps of ``starts`` [j, B] (int32, on the device, j <= k)."""
        j = starts.shape[0]
        if not 1 <= j <= self.k:
            raise ValueError(f"a block of {j} steps; this function takes 1..{self.k}")
        self._draw(j)
        self.starts[:j].copy_(starts)
        if not self.on_card:
            self._eager(j)
        elif j < self.k or not self.warm or self.graph is None:
            main = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                if j == self.k and self.warm:
                    self._capture()
                    self.graph.replay()
                    self._count_replay()
                else:
                    self._eager(j)
                    self.warm = self.warm or j == self.k
            main.wait_stream(self.stream)
        else:
            self.graph.replay()
            self._count_replay()
        self.state.step += j
        self.state.last_mismatched_nll = self.last
        return {key: v[:j].clone() for key, v in self.out.items()}

    def _count_replay(self) -> None:
        MultiStep.replays += 1
        for f, counts in self.graph_launches.items():
            _add_counters(f, counts)

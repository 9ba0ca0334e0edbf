"""Data parallelism across GPUs (the port of
``lets_face_it_tpu/parallel/mesh.py``).

The model is small (about 10 M parameters) and the batch large (256
windows), so the port scales as the JAX package does: pure data
parallelism over one ``data`` axis. One process a GPU, started by
``torchrun``; every rank holds the whole model, takes its slice of axis 0
of each batch, and the gradients are averaged with one all-reduce of a
flat buffer (``train/state.py::apply_step``), which a CUDA graph can hold
over NCCL. What must be the same on every rank is made so: the model and
optimizer state are broadcast from rank 0 (``replicate``); the step's
random draws are taken for the global batch from the same generator on
every rank and sliced (``local``); the loss the negative-NLL trick reads is
the global mean. Tensor, pipeline and sequence parallelism do not apply to
this model family (the JAX module says why).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: its ``rank`` of
    ``size``, its device and the group's backend ('nccl' or 'gloo')."""
    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of ``n`` (a multiple of ``size``)."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over {self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def local(self, t):
        """This rank's slice of axis 0 of ``t`` (a tensor or an array)."""
        return t[self.rows(t.shape[0])]

    def all_gather(self, t):
        """[b, ...] from every rank -> [size * b, ...] in rank order."""
        t = t.contiguous()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, t)
        else:
            dist.all_gather(list(out.chunk(self.size)), t)
        return out

    def all_reduce_mean(self, t):
        """``t`` (in place) averaged over the ranks."""
        dist.all_reduce(t)
        return t.div_(self.size)

    def average_gradients(self, grads) -> None:
        """Every gradient (in place) averaged over the ranks, by one
        all-reduce of a flat buffer."""
        flat = self.all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]))
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (pickled)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def make_mesh(device="cuda", backend: str | None = None) -> Mesh:
    """The data-parallel group of this ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` from
    the environment), initialised once: NCCL on the card, each rank on
    cuda:LOCAL_RANK, and gloo on the CPU. ``backend`` overrides it (gloo
    runs several ranks on one card, which NCCL refuses)."""
    dev = torch.device(device)
    local_rank = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://")
    return Mesh(dist.get_rank(), dist.get_world_size(), dev, dist.get_backend())


def mesh_from_environment(device="cuda", backend: str | None = None):
    """``make_mesh`` under ``torchrun`` (``WORLD_SIZE`` set), else None."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return make_mesh(device, backend)


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """Each modality's rows of this rank (axis 0)."""
    return {k: mesh.local(v) for k, v in batch.items()}


@torch.no_grad()
def replicate(mesh: Mesh, model: torch.nn.Module, optimizer=None) -> None:
    """Rank 0's parameters and buffers, and its optimizer state where there
    is one, on every rank (in place)."""
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src=0)
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                for v in optimizer.state.get(p, {}).values():
                    if torch.is_tensor(v):
                        dist.broadcast(v, src=0)


def pad_batch(batch: dict, multiple: int):
    """Pad the batch dim up to a multiple (for even sharding of last batches).
    Returns (padded_batch, real_count)."""
    b = next(iter(batch.values())).shape[0]
    rem = b % multiple
    if rem == 0:
        return batch, b
    pad = multiple - rem
    padded = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
              for k, v in batch.items()}
    return padded, b

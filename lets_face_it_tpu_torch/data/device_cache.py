"""Device-resident window gathering: ship indices, not windows (the port of
``lets_face_it_tpu/data/device_cache.py``).

The host path gathers each training batch into fresh arrays and uploads
them every step: 256 x 80 x (56 + 56 + 30 + 30) floats, about 14.1 MB, for
``final_model``. ``DeviceWindowBatcher`` instead uploads a split's
concatenated modality arrays once and gathers each batch on the device from
a [B] int32 vector of window starts: ``idx = starts[:, None] + arange(T)``,
then one indexing op per modality. The values are bit-identical to
``WindowDataset.get_batch``: the same float32 arrays, the same slices.

Policy, ``hp.device_data_cache`` = auto (default) | on | off: ``auto`` caches
a split on a CUDA device when it fits the card's budget
(``auto_budget_bytes``) together with the splits already cached, and stays
on the host path on the CPU, where there is no upload to save; ``on``
caches on any device, the CPU included.
"""

from __future__ import annotations

import numpy as np
import torch

# Device memory the auto policy leaves to training: a final_model run at
# B=256 (the steps, with the conditioning gates kept for the backward and
# the encoders' activations, and a validation) peaks 8.934 GB above what
# was allocated before it (chip_smoke.py on an NVIDIA H100 80GB HBM3 at
# 700 W); twice that, rounded up to whole GiB, leaves room for the
# allocator's cache.
STEP_RESERVE_BYTES = 18 * 1024**3


def auto_budget_bytes(device) -> int:
    """The bytes ``auto`` may cache on ``device``: its total memory less
    ``STEP_RESERVE_BYTES``."""
    total = torch.cuda.get_device_properties(torch.device(device)).total_memory
    return max(total - STEP_RESERVE_BYTES, 0)


def gather_windows(arrays: dict, starts, seq_len: int) -> dict:
    """``{mod: [T, D]}`` and [B] starts -> ``{mod: [B, seq_len, D]}``, on the
    device of the arrays."""
    idx = starts[:, None] + torch.arange(seq_len, dtype=starts.dtype,
                                         device=starts.device)[None, :]
    return {k: a[idx] for k, a in arrays.items()}


class DeviceWindowBatcher:
    """A split's modality arrays on ``device`` and the gather over them."""

    def __init__(self, ds, device):
        self.seq_len = int(ds.seq_len)
        self.device = torch.device(device)
        self.window_starts = np.asarray(ds.window_starts, np.int64)
        self.arrays = {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device)
                       for k, v in ds.arrays.items()}
        self.total_bytes = int(sum(v.nbytes for v in ds.arrays.values()))

    def get_batch(self, indices) -> dict:
        """The windows at ``window_starts[indices]``, gathered on the device
        on the current stream: the same {modality: [B, T, D]} as
        ``WindowDataset.get_batch``, as tensors, bit-equal values."""
        starts = self.window_starts[np.asarray(indices)].astype(np.int32)
        starts = torch.from_numpy(starts).to(self.device, non_blocking=True)
        return gather_windows(self.arrays, starts, self.seq_len)


def cache_mode(hp) -> str:
    """``hp.device_data_cache`` as 'auto', 'on' or 'off'. YAML 1.1 parses a
    bare ``on``/``off`` as a boolean: those keep their meaning."""
    raw = getattr(hp, "device_data_cache", "auto")
    if isinstance(raw, bool):
        return "on" if raw else "off"
    mode = str(raw or "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"device_data_cache={mode!r}: expected auto|on|off")
    return mode


def make_device_batcher(ds, hp, device, reserved_bytes: int = 0):
    """A ``DeviceWindowBatcher`` for ``ds`` on ``device``, or None for the
    host path, by ``cache_mode(hp)``. ``reserved_bytes``: device memory
    already claimed by other cached splits; the auto budget applies to the
    sum, so caching the train split shrinks the val split's allowance."""
    mode = cache_mode(hp)
    device = torch.device(device)
    if mode == "off":
        return None
    if mode == "auto":
        if device.type != "cuda":
            return None
        total = int(sum(v.nbytes for v in ds.arrays.values()))
        budget = auto_budget_bytes(device)
        if total + reserved_bytes > budget:
            print(f"device_data_cache=auto: split is {total / 1e9:.2f} GB "
                  f"(+{reserved_bytes / 1e9:.2f} GB already cached) > "
                  f"{budget / 1e9:.1f} GB budget; streaming from the host",
                  flush=True)
            return None
    return DeviceWindowBatcher(ds, device)

"""The trainer's ``precision`` switch as torch's ambient matmul precision.

``hp.precision`` (the CLI's ``--precision``) is 32 or 16, as in the JAX
trainer (train.py:103-106): 32 runs every product in float32 ("highest"), 16
in the production arithmetic, bf16 operands with float32 sums ("medium").
The kernels read the ambient setting (``ops/flow_kernels.py::
ambient_matmul_precision``); eager cuBLAS products run at whatever torch
gives for it on the card (TF32 for "medium").
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = {32: "highest", 16: "medium"}


def training_precision(hp) -> str:
    """The ambient matmul precision of ``hp.precision`` (default 32);
    raises ``ValueError`` for any other value."""
    bits = int(getattr(hp, "precision", 32) or 32)
    if bits not in PRECISIONS:
        raise ValueError(f"precision {bits}: expected 16 or 32")
    return PRECISIONS[bits]


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Run the block at ``torch.set_float32_matmul_precision(precision)``;
    on exit restore the previous setting and both TF32 flags
    (``torch.backends.cuda.matmul.allow_tf32``, which the setting moves, and
    ``torch.backends.cudnn.allow_tf32``), whatever the block raised."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision(precision)
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]

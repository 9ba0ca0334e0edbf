"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, loaded through ``ctypes``; sources that need building are compiled
in parallel, one ``nvcc`` each. Libraries go to ``lets_face_it_tpu_torch/_build/``
(ignored by git), keyed by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import time: the package imports on machines without
``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("frame_rev", "seq_rev", "sample_gates", "sample_chain", "cond_gates",
           "seq_fwd", "seq_bwd", "seq_fwd_hsplit", "seq_bwd_hsplit")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "csrc/ with the CUDA toolkit's nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, all in
    parallel; returns name -> path. Raises with nvcc's output on failure.
    The compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failures = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        paths[name].with_suffix(".log").write_text(out)
        os.replace(tmp, paths[name])     # atomic: concurrent builders agree
    if failures:
        raise RuntimeError("\n".join(failures))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (building it if needed)."""
    return ctypes.CDLL(str(build((name,))[name]))

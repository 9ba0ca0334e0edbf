"""Lazy builder and loader for the repo's native C++ helpers (``ctypes``).

``load_library("window_loader")`` compiles ``native/window_loader.cpp`` at
first use with ``g++ -O3 -fPIC -fopenmp -shared`` into the port's git-ignored
``lets_face_it_tpu_torch/_build/`` (keyed by a hash of the source and the
flags, so an edited source is rebuilt) and loads it. It never writes into
``native/`` and never loads a prebuilt library from there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-Wall", "-std=c++17", "-shared")


class NativeBuildError(RuntimeError):
    pass


def build(name: str) -> Path:
    src = NATIVE_DIR / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src.read_bytes())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(f"building {name} failed:\n{proc.stderr[-3000:]}")
    os.replace(tmp, lib)          # atomic: concurrent builders agree
    return lib


_cache: dict[str, ctypes.CDLL] = {}


def load_library(name: str) -> ctypes.CDLL:
    if name not in _cache:
        _cache[name] = ctypes.CDLL(str(build(name)))
    return _cache[name]

"""Lazy builder and loader for the repo's native C++ helpers (``ctypes``).

``load_library("window_loader")`` compiles ``native/window_loader.cpp`` at
first use with ``g++ -O3 -fPIC -fopenmp -shared`` into the port's git-ignored
``lets_face_it_tpu_torch/_build/`` (keyed by a hash of the source and the
flags, so an edited source is rebuilt) and loads it. It never writes into
``native/`` and never loads a prebuilt library from there.

``native/rasterizer.cpp`` is built with the flags of ``native/Makefile``, as
the JAX package builds it, ``-march=native`` included: with it g++ contracts
``a * b + c`` into fused multiply-adds, which moves pixels on triangle edges,
so only the same flags draw the same images. What ``-march=native`` means on
this host is then part of the key, so a library built for another CPU is
never loaded.
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
EXTRA_FLAGS = {"rasterizer": ("-march=native",)}


class NativeBuildError(RuntimeError):
    pass


def _native_target() -> bytes:
    """The target options ``-march=native`` enables on this host."""
    return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, check=True).stdout


def build(name: str) -> Path:
    src = NATIVE_DIR / f"{name}.cpp"
    flags = CXX_FLAGS + EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    if "-march=native" in flags:
        digest.update(_native_target())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(src)],
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

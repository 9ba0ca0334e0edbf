"""Infra configuration (the port's copy of ``lets_face_it_tpu/config.py``):
``config.toml`` at the repo root merged with an optional
``config.local.toml`` (recursive dict update), the three-tier config of the
reference (misc/shared.py:7-42, config.toml). The port's only reader is the
trainer's logger (``train/loop.py::MetricLogger``), for the Comet section,
so only that section has defaults; other sections pass through from the
files. Nothing is read at import.
"""

from __future__ import annotations

import tomllib
from collections import abc
from pathlib import Path

BASE_PATH = Path(__file__).resolve().parents[1]

_DEFAULTS: dict = {
    "comet": {"api_key": "", "project_name": "lets_face_it"},
}


def _update(d: dict, u: dict) -> dict:
    for k, v in u.items():
        if isinstance(v, abc.Mapping):
            d[k] = _update(dict(d.get(k, {})), v)
        else:
            d[k] = v
    return d


def load_config(base_path: Path | None = None) -> dict:
    base = Path(base_path) if base_path else BASE_PATH
    cfg = {k: dict(v) for k, v in _DEFAULTS.items()}
    for name in ("config.toml", "config.local.toml"):
        path = base / name
        if path.exists():
            _update(cfg, tomllib.loads(path.read_text()))
    return cfg

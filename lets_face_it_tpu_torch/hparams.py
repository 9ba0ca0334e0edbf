"""Experiment configuration (the port's copy of ``lets_face_it_tpu/hparams.py``).

Reads the same YAML hparams files as the JAX package (``hparams/*.yaml``),
including unmodified reference glow_pytorch configs: PyTorch-Lightning trainer
keys are accepted and kept. JSON-with-comments configs are supported
(``//`` comment stripping). The port keeps its own copy because importing
anything from ``lets_face_it_tpu`` imports JAX.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from types import SimpleNamespace
from typing import Any

import yaml

# Defaults for keys the harness consumes. Mirrors what the reference gets from
# ``Trainer.add_argparse_args`` defaults + YAML merge (glow/utils.py:35-37).
_HARNESS_DEFAULTS: dict[str, Any] = {
    "batch_size": 256,
    "lr": 1e-4,
    "max_epochs": 30,
    "min_epochs": 1,
    "gradient_clip_val": 0.0,
    "accumulate_grad_batches": 1,
    "precision": 32,
    "check_val_every_n_epoch": 1,
    "val_check_interval": 1.0,
    "num_sanity_val_steps": 1,
    "deterministic": True,
    "checkpoint_callback": True,
    "resume_from_checkpoint": None,
    "default_root_dir": None,
    "max_steps": None,
    "train_percent_check": 1.0,
    "val_percent_check": 1.0,
    "test_percent_check": 1.0,
    "terminate_on_nan": False,
    "overfit_pct": 0.0,
    "logger": True,
}

_MODALITIES = ("p1_face", "p1_speech", "p2_face", "p2_speech")


class HParams(SimpleNamespace):
    """Attribute-style view over the merged config dict."""

    def to_dict(self) -> dict:
        return {k: v for k, v in vars(self).items()}


def _strip_json_comments(text: str) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return text


def load_hparams(path: str | Path, dataset_root: str | Path | None = None,
                 overrides: dict | None = None) -> HParams:
    path = Path(path)
    if path.suffix == ".json":
        raw = json.loads(_strip_json_comments(path.read_text()))
    else:
        raw = yaml.safe_load(path.read_text())

    merged = dict(_HARNESS_DEFAULTS)
    merged.update(raw)
    if overrides:
        merged.update(overrides)

    merged.setdefault("Glow", {})
    if not merged["Glow"].get("rnn_type"):
        merged["Glow"]["rnn_type"] = "gru"
    merged["Glow"].setdefault("actnorm_scale", 1.0)
    merged["Glow"].setdefault("scale_eps", 1e-6)
    merged["Glow"].setdefault("L", 1)
    merged["Glow"].setdefault("LU_decomposed", True)
    merged.setdefault("Validation", {}).setdefault("scale_logging", False)
    merged.setdefault("Infer", {"eps": 1.0, "seq_len": 25})
    merged.setdefault("Train", {}).setdefault("use_negative_nll_loss", False)

    if dataset_root is not None:
        merged["dataset_root"] = str(dataset_root)
    merged.setdefault("dataset_root", str(Path.cwd() / "dataset"))

    hp = HParams(**merged)
    hp.config_name = path.name
    validate_hparams(hp)
    return hp


def validate_hparams(hp: HParams) -> None:
    """Config invariants (reference: glow/utils.py:116-122) plus dim checks."""
    train_len = hp.Train["seq_len"]
    val_len = hp.Validation["seq_len"]
    for m in _MODALITIES:
        his = hp.Conditioning[m]["history"] + 1
        assert his < train_len, f"{m}: history+1={his} must be < train seq_len {train_len}"
        assert his < val_len, f"{m}: history+1={his} must be < val seq_len {val_len}"
    x_dim = hp.Conditioning["p1_face"]["dim"]
    data_dim = hp.Data["expression_dim"] + hp.Data["jaw_dim"] + hp.Data["neck_dim"]
    # dim == 0 disables own-face conditioning (no_face ablation); otherwise it
    # must agree with the packed face layout
    assert x_dim in (0, data_dim), (
        f"p1_face dim {x_dim} must be 0 or expression+jaw+neck = {data_dim}")
    assert hp.Glow["flow_coupling"] in ("additive", "affine")
    assert hp.Glow["flow_permutation"] in ("invconv", "shuffle", "reverse")
    assert hp.Glow["rnn_type"] in ("gru", "lstm")


def longest_history(conditioning: dict) -> int:
    """Max history over the four conditioning modalities (glow/utils.py:44-50)."""
    return max(conditioning[m]["history"] for m in _MODALITIES)

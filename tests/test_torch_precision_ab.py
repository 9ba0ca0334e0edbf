"""The port's precision A/B artifact, ``runs/precision_ab_torch.json``
(``python -m lets_face_it_tpu_torch.precision_ab``): ``final_model`` trained
at precision 32 and at precision 16 on the card, same seed and synthetic
corpus. Pinned as tests/test_precision_ab.py pins the JAX package's
artifact, with the same limits (20 bits, 0.5 % relative); skipped when the
file is absent.
"""

import json
from pathlib import Path

import pytest

ARTIFACT = Path(__file__).resolve().parent.parent / "runs" / "precision_ab_torch.json"


def _load():
    if not ARTIFACT.exists():
        pytest.skip("runs/precision_ab_torch.json absent: regenerate it on the "
                    "card with python -m lets_face_it_tpu_torch.precision_ab")
    return json.loads(ARTIFACT.read_text())


def test_precision_ab_torch_artifact_integrity():
    d = _load()
    s = d["summary"]
    assert d["config"] == "final_model"
    assert d["max_steps"] >= 5000
    assert "H100" in d["card"]
    assert s["shared_val_steps"] >= 8
    assert s["final_step"] == d["max_steps"]
    for arm, bits in (("f32", 32), ("bf16", 16)):
        assert d["arms"][arm]["precision"] == bits
        curve = d["arms"][arm]["curve"]
        assert len(curve) >= 8
        assert [r["step"] for r in curve] == sorted(r["step"] for r in curve)


def test_precision_ab_torch_bf16_matches_f32_convergence():
    """Precision 16 converges as precision 32 does: within 20 bits of NLL at
    every shared validation and 0.5 % relative at the last."""
    d = _load()
    s = d["summary"]
    assert abs(s["final_delta_bits"]) < 20.0
    assert s["max_abs_delta_bits"] < 20.0
    assert abs(s["final_delta_relative"]) < 0.005

"""The device data cache at corpus scale on the card, and the probe's
function on the CPU.

``runs/device_cache_scale_torch.json`` (``python -m
lets_face_it_tpu_torch.device_cache_scale_probe``) holds the run on the
card: 2,900 train chunks of 1,000 frames (about 2 GB of modality arrays,
2.67 M windows) and the val split cached by the ``auto`` policy, trained at
B=256 in k=8 blocks and at B=1024 beside them, with a cached-val evaluation;
held as tests/test_device_cache_scale.py holds the JAX record, with the
card's memory: the peak within the card, at least 1 GB of headroom.
"""

import json
import math
from pathlib import Path

import pytest

from lets_face_it_tpu_torch import device_cache_scale_probe as scale
from lets_face_it_tpu_torch.data.synthetic import dims_for

from test_torch_port_common import port_hp, train_hp

ARTIFACT = Path(__file__).resolve().parent.parent / "runs" / "device_cache_scale_torch.json"
KEYS = {"train_split_gb", "val_split_gb", "windows_train", "mem_after_cache",
        "b256_k8_steps_per_sec", "b256_nll_final", "mem_after_b256",
        "b1024_nll_final", "mem_after_b1024", "val_nll", "launches",
        "peak_allocated_gb", "peak_gb", "hbm_limit_gb", "headroom_gb"}


@pytest.fixture(scope="module")
def artifact():
    assert ARTIFACT.exists(), (
        "runs/device_cache_scale_torch.json missing: run python -m "
        "lets_face_it_tpu_torch.device_cache_scale_probe on the card and commit it")
    return json.loads(ARTIFACT.read_text())


def test_scale_artifact_integrity(artifact):
    d = artifact
    assert "NVIDIA" in d["device"] and d["power_limit_w"] > 0
    assert KEYS <= set(d)
    assert d["train_split_gb"] >= 1.5
    assert d["val_split_gb"] >= 0.1
    assert d["windows_train"] >= 2_000_000
    assert d["b256_k8_steps_per_sec"] > 0
    for key in ("b256_nll_final", "b1024_nll_final", "val_nll"):
        assert math.isfinite(d[key]), key
    assert all(n > 0 for n in d["launches"].values())


def test_scale_artifact_memory_headroom(artifact):
    """The caches, the B=256 state with its k-step graph and the B=1024
    step's peak fit on the card with room to spare."""
    d = artifact
    assert d["peak_allocated_gb"] <= d["peak_gb"] <= d["hbm_limit_gb"]
    assert d["headroom_gb"] >= 1.0
    assert d["headroom_gb"] == pytest.approx(d["hbm_limit_gb"] - d["peak_gb"])


def test_probe_runs_on_the_cpu_with_the_cache_forced_on():
    """20 chunks of 200 frames at tiny widths, the cache ``on``: every key
    of the record, the splits' sizes and windows, finite losses; memory is
    not measured off the card."""
    hp = port_hp(train_hp())
    seq_len = hp.Train["seq_len"]
    corpus = scale.scale_corpus(20, 2, 200, dims=dims_for(hp.Data))
    report = scale.run(hp, corpus, device="cpu", steps=8, big_steps=1, cache="on")
    assert set(report) == KEYS
    assert report["windows_train"] == 20 * (200 - seq_len + 1)
    assert report["train_split_gb"] > report["val_split_gb"] > 0
    for key in ("b256_k8_steps_per_sec", "b256_nll_final", "b1024_nll_final", "val_nll"):
        assert math.isfinite(report[key]), key
    assert all(report[k] is None for k in KEYS if k.startswith(("mem_", "peak", "hbm",
                                                                 "headroom")))


def test_probe_refuses_a_split_the_policy_does_not_cache():
    """``auto`` caches nothing on the CPU: the probe raises rather than run
    on the host path."""
    hp = port_hp(train_hp())
    corpus = scale.scale_corpus(2, 1, 60, dims=dims_for(hp.Data))
    with pytest.raises(RuntimeError, match="refused the train split"):
        scale.run(hp, corpus, device="cpu", steps=8, big_steps=1)

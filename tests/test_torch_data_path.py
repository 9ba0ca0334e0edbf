"""The port's data path on the CPU: the native window gather, the background
prefetch (the cases of tests/test_prefetch.py), the device-resident batcher
with ``device_data_cache: on`` (bit for bit against ``get_batch`` and the JAX
package's batches), the cache policy (auto, the budget, invalid modes, YAML
booleans) and the trainer's trajectory with the cache on, off and auto."""

import threading
import time

import numpy as np
import pytest
import torch
import yaml

from lets_face_it_tpu.data.prefetch import NativeGather as JaxNativeGather
from lets_face_it_tpu.data.synthetic import write_synthetic_dataset
from lets_face_it_tpu.data.windows import WindowDataset as JaxWindowDataset
from lets_face_it_tpu_torch.data import device_cache as dc
from lets_face_it_tpu_torch.data import prefetch as pf
from lets_face_it_tpu_torch.data.synthetic import make_synthetic_corpus, tiny_dims
from lets_face_it_tpu_torch.data.windows import WindowDataset
from lets_face_it_tpu_torch.train import loop as ploop
from lets_face_it_tpu_torch.utils import native

from test_torch_port_common import port_hp, tiny_hp, train_hp

CORPUS = dict(n_train_chunks=3, n_val_chunks=1, n_test_chunks=1,
              frames_per_chunk=40, seed=2, dims=tiny_dims())


@pytest.fixture(scope="module")
def ds():
    hp = tiny_hp()
    return WindowDataset.from_chunks(make_synthetic_corpus(**CORPUS), "train",
                                     hp.Data, hp.Conditioning, hp.Train["seq_len"])


def _hp(**kw):
    hp = port_hp(tiny_hp())
    for k, v in kw.items():
        setattr(hp, k, v)
    return hp


# ---------------------------------------------------------------------------
# Native gather
# ---------------------------------------------------------------------------

def test_native_gather_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    src = np.ascontiguousarray(rng.standard_normal((500, 23)), np.float32)
    starts = rng.integers(0, 500 - 40, 17)
    got = pf.NativeGather.gather(src, starts, 40)
    idx = starts[:, None] + np.arange(40)[None, :]
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, JaxNativeGather.gather(src, starts, 40))
    assert pf.NativeGather.available(), "the native loader should build here"
    out = np.zeros((17, 40, 23), np.float32)
    assert pf.NativeGather.gather(src, starts, 40, out=out) is out
    np.testing.assert_array_equal(out, src[idx])


def test_native_library_builds_into_the_ports_build_dir():
    path = native.build("window_loader")
    assert path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "lets_face_it_tpu_torch"
    assert native.build("window_loader") == path


def test_numpy_fallback_says_so_once(monkeypatch, capsys):
    """Where the native loader cannot be built, the numpy gather gives the
    same windows and says once that it is in use."""
    monkeypatch.setattr(pf.NativeGather, "_tried", False)
    monkeypatch.setattr(pf.NativeGather, "_lib", None)
    monkeypatch.setattr(pf.NativeGather, "_warned", False)
    monkeypatch.setattr(native, "NATIVE_DIR", native.NATIVE_DIR / "missing")
    monkeypatch.setattr(native, "_cache", {})
    rng = np.random.default_rng(1)
    src = rng.standard_normal((60, 5)).astype(np.float32)
    starts = np.array([0, 7, 20])
    for _ in range(3):
        got = pf.NativeGather.gather(src, starts, 9)
        np.testing.assert_array_equal(got, src[starts[:, None] + np.arange(9)])
    assert not pf.NativeGather.available()
    assert capsys.readouterr().err.count("NativeGather") == 1


def test_gather_host_equals_get_batch(ds):
    idx = np.random.default_rng(3).permutation(len(ds))[:6]
    got = pf.gather_host(ds, idx)
    want = ds.get_batch(idx)
    assert list(got) == list(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


# ---------------------------------------------------------------------------
# Prefetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_transfer", [False, True])
def test_prefetch_preserves_order_and_content(with_transfer):
    """Every item, in order; ``transfer`` applied to each, in the worker
    thread (the gather and upload of the trainer)."""
    main = threading.get_ident()
    seen = []

    def transfer(item):
        seen.append(threading.get_ident())
        return {k: v + 1 for k, v in item.items()}

    items = [{"x": np.full((2, 2), i)} for i in range(20)]
    out = list(pf.prefetch_batches(iter(items), depth=3,
                                   transfer=transfer if with_transfer else None))
    assert len(out) == 20
    for i, item in enumerate(out):
        np.testing.assert_array_equal(item["x"], np.full((2, 2), i + with_transfer))
    assert len(seen) == (20 if with_transfer else 0)
    assert all(t != main for t in seen)


def _bad_transfer(item):
    raise RuntimeError("boom in transfer")


def _bad_iterator():
    yield {"x": np.zeros(2)}
    raise RuntimeError("boom in iterator")


@pytest.mark.parametrize("source", ["transfer", "iterator"])
def test_prefetch_errors_propagate(source):
    if source == "transfer":
        it = pf.prefetch_batches(iter([{"x": np.zeros(2)}]), transfer=_bad_transfer)
    else:
        it = pf.prefetch_batches(_bad_iterator())
        assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match=f"boom in {source}"):
        list(it)


def test_prefetch_early_break_releases_worker():
    """An abandoned prefetch generator (the trainer's max_steps break) stops
    its worker and drops what it queued."""
    produced = []

    def gen():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.full((2,), i)}
            i += 1

    before = set(threading.enumerate())
    it = pf.prefetch_batches(gen(), depth=2)
    assert next(it) is not None
    it.close()
    extra = [t for t in threading.enumerate() if t not in before]
    deadline = time.time() + 6
    while time.time() < deadline and any(t.is_alive() for t in extra):
        time.sleep(0.05)
    assert not any(t.is_alive() for t in extra), "worker thread leaked"
    n = len(produced)
    time.sleep(0.2)
    assert len(produced) == n, "worker kept producing after close"


def test_side_stream_transfer_on_cpu_passes_through(ds):
    """On the CPU the staged batch carries no event and ``receive`` returns it
    as it is (the card's path waits on the side stream's event)."""
    transfer = ploop.batch_transfer(ds, "cpu")
    assert transfer.stream is None
    batch, event = transfer(np.arange(4))
    assert event is None
    assert pf.receive((batch, event)) is batch
    for k, v in ds.get_batch(np.arange(4)).items():
        np.testing.assert_array_equal(batch[k].numpy(), v)


# ---------------------------------------------------------------------------
# Device cache
# ---------------------------------------------------------------------------

def test_device_batcher_on_cpu_bit_exact(ds, tmp_path):
    """``device_data_cache: on`` on the CPU: the batcher's gather equals
    ``get_batch`` and the JAX package's host batch bit for bit."""
    batcher = dc.make_device_batcher(ds, _hp(device_data_cache="on"), "cpu")
    assert isinstance(batcher, dc.DeviceWindowBatcher)
    assert batcher.total_bytes == sum(v.nbytes for v in ds.arrays.values())
    write_synthetic_dataset(tmp_path / "s.h5", **CORPUS)
    hp = tiny_hp()
    jds = JaxWindowDataset(tmp_path / "s.h5", "train", hp.Data, hp.Conditioning,
                           hp.Train["seq_len"])
    for idx in (np.random.default_rng(0).permutation(len(ds))[:16], np.array([len(ds) - 1])):
        got, host, jax_host = batcher.get_batch(idx), ds.get_batch(idx), jds.get_batch(idx)
        assert set(got) == set(host) == set(jax_host)
        for k in host:
            assert got[k].shape == host[k].shape
            np.testing.assert_array_equal(got[k].numpy(), host[k])
            np.testing.assert_array_equal(got[k].numpy(), jax_host[k])


def test_gather_windows_int32_starts():
    arrays = {"a": torch.arange(60, dtype=torch.float32).reshape(20, 3)}
    starts = torch.tensor([0, 5, 12], dtype=torch.int32)
    got = dc.gather_windows(arrays, starts, 4)["a"]
    want = arrays["a"].numpy()[starts.numpy()[:, None] + np.arange(4)]
    np.testing.assert_array_equal(got.numpy(), want)


def test_cache_policy_modes(ds):
    """auto stays on the host path on the CPU; off is off; on is on; a typo
    raises; YAML's bare on/off (booleans) keep their meaning."""
    assert dc.make_device_batcher(ds, _hp(), "cpu") is None                # auto
    assert dc.make_device_batcher(ds, _hp(device_data_cache="off"), "cpu") is None
    assert dc.make_device_batcher(ds, _hp(device_data_cache="ON"), "cpu") is not None
    with pytest.raises(ValueError, match="device_data_cache"):
        dc.make_device_batcher(ds, _hp(device_data_cache="offf"), "cpu")
    for text, cached in (("on", True), ("off", False), ("auto", False)):
        value = yaml.safe_load(f"device_data_cache: {text}")["device_data_cache"]
        assert isinstance(value, bool) == (text != "auto")
        got = dc.make_device_batcher(ds, _hp(device_data_cache=value), "cpu")
        assert (got is not None) == cached, text


def test_auto_budget_rule(monkeypatch):
    class Props:
        total_memory = 85_000_000_000

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    assert dc.auto_budget_bytes("cuda") == 85_000_000_000 - dc.STEP_RESERVE_BYTES
    Props.total_memory = dc.STEP_RESERVE_BYTES // 2
    assert dc.auto_budget_bytes("cuda") == 0


def test_auto_policy_budget_with_reserved_bytes(ds, monkeypatch, capsys):
    """On a card, auto caches a split that fits the budget, and the bytes
    other splits already hold count against it."""
    total = sum(v.nbytes for v in ds.arrays.values())
    made = []
    monkeypatch.setattr(dc, "auto_budget_bytes", lambda device: 2 * total)
    monkeypatch.setattr(dc, "DeviceWindowBatcher",
                        lambda d, device: made.append(device) or "batcher")
    assert dc.make_device_batcher(ds, _hp(), "cuda") == "batcher"
    assert made == [torch.device("cuda")]
    assert dc.make_device_batcher(ds, _hp(), "cuda", reserved_bytes=total) == "batcher"
    assert dc.make_device_batcher(ds, _hp(), "cuda", reserved_bytes=total + 1) is None
    assert "streaming from the host" in capsys.readouterr().out
    assert dc.make_device_batcher(ds, _hp(device_data_cache="off"), "cuda") is None


# ---------------------------------------------------------------------------
# The trainer's data order
# ---------------------------------------------------------------------------

def _train(mode, max_steps=7):
    hp = port_hp(train_hp())
    hp.batch_size = 8
    hp.max_epochs = 3
    hp.logger = False
    hp.device_data_cache = mode
    corpus = ploop.synthetic_corpus(hp, 5, n_train_chunks=2, n_val_chunks=1,
                                    n_test_chunks=1, frames_per_chunk=40)
    steps, vals = [], []
    state, _ = ploop.train(hp, seed=5, max_steps=max_steps, device="cpu",
                           corpus=corpus, verbose=False,
                           step_hook=lambda s, m: steps.append(
                               {k: float(v) for k, v in m.items()}),
                           val_hook=lambda s, m: vals.append((s, m)))
    params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    return steps, vals, params


def test_train_trajectory_invariant_to_device_cache():
    """The cache on, off and auto (off on the CPU) give the same trajectory
    bit for bit: the same (seed, epoch) order, the same float32 values.
    7 steps of epochs of 6 batches cross an epoch boundary and stop
    mid-epoch."""
    runs = {mode: _train(mode) for mode in ("off", "on", "auto")}
    steps_off, vals_off, params_off = runs["off"]
    assert len(steps_off) == 7 and [s for s, _ in vals_off] == [6, 7]
    for mode in ("on", "auto"):
        steps, vals, params = runs[mode]
        assert steps == steps_off, mode
        assert vals == vals_off, mode
        for name, p in params_off.items():
            assert torch.equal(params[name], p), (mode, name)

"""The device data cache at corpus scale (the counterpart of
``tools/device_cache_scale_probe.py``).

    python -m lets_face_it_tpu_torch.device_cache_scale_probe [--device cuda]
        [--steps 40] [--big_steps 3] [--out runs/device_cache_scale_torch.json]

The real corpus is about 2.07 M frames at 25 fps with both roles of each
segment: 2,900 train chunks of 1,000 frames, 2.9 M rows of 172 float32
columns, about 2.0 GB of modality arrays, and 290 val chunks (0.2 GB). This
probe builds such a corpus in memory (``data/synthetic.py``, seed 7, as the
JAX tool writes it), requires the ``auto`` policy
(``data/device_cache.py``) to cache both splits, then trains
``final_model`` at "highest" (precision 32): ``steps`` steps at B=256 in
blocks of 8 (``train/state.py::MultiStep``, one CUDA graph a block,
gathering over the cached split; timed after two warm-up blocks),
``big_steps`` steps at B=1024 beside it, and one evaluation of a B=256 batch
gathered from the cached val split. Device memory (``torch.cuda``'s peak
allocated and reserved bytes, and the card's total) after each phase gives
the headroom left beside the caches. ``tests/test_torch_device_cache_scale.py``
pins the JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

from lets_face_it_tpu_torch.ablation_table1 import index_batches, kernel_launches

REPO = Path(__file__).resolve().parent.parent
N_TRAIN_CHUNKS, N_VAL_CHUNKS, N_TEST_CHUNKS = 2900, 290, 2
FRAMES_PER_CHUNK = 1000
CORPUS_SEED = 7
BATCH, BIG_BATCH, K_DISPATCH = 256, 1024, 8
GB = 1024**3


def scale_corpus(n_train_chunks: int = N_TRAIN_CHUNKS, n_val_chunks: int = N_VAL_CHUNKS,
                 frames_per_chunk: int = FRAMES_PER_CHUNK, dims=None):
    """The JAX tool's corpus (seed 7), built in memory."""
    from lets_face_it_tpu_torch.data.synthetic import make_synthetic_corpus

    return make_synthetic_corpus(n_train_chunks=n_train_chunks,
                                 n_val_chunks=n_val_chunks, n_test_chunks=N_TEST_CHUNKS,
                                 frames_per_chunk=frames_per_chunk, seed=CORPUS_SEED,
                                 dims=dims)


def mem_stats(device):
    """Device memory in bytes on the card: allocated now, the peaks since
    the probe began, the total; None elsewhere (not measured)."""
    import torch

    if device.type != "cuda":
        return None
    return {"allocated": torch.cuda.memory_allocated(device),
            "peak_allocated": torch.cuda.max_memory_allocated(device),
            "peak_reserved": torch.cuda.max_memory_reserved(device),
            "total": torch.cuda.get_device_properties(device).total_memory}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(hp, corpus, *, device="cuda", steps: int = 40, big_steps: int = 3,
        cache: str = "auto") -> dict:
    """The probe on ``corpus`` with ``hp`` (``final_model``'s on the card);
    ``cache`` the device-cache policy (``auto`` on the card, ``on`` to run it
    on the CPU). -> the report (the JAX tool's keys, and the memory and the
    training kernels' launches)."""
    import torch

    from lets_face_it_tpu_torch.ablation_table1 import require_kernels
    from lets_face_it_tpu_torch.data.device_cache import make_device_batcher
    from lets_face_it_tpu_torch.model import seqglow
    from lets_face_it_tpu_torch.model.seqglow import SeqGlow
    from lets_face_it_tpu_torch.model.spec import FlowSpec
    from lets_face_it_tpu_torch.train import state as train_state
    from lets_face_it_tpu_torch.train.loop import load_datasets
    from lets_face_it_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    hp.device_data_cache = cache
    spec = FlowSpec.build(hp)
    require_kernels(spec)
    train_ds, val_ds = load_datasets(hp, corpus)
    batcher = make_device_batcher(train_ds, hp, device)
    if batcher is None:
        raise RuntimeError(f"device_data_cache={cache} refused the train split")
    val_batcher = make_device_batcher(val_ds, hp, device,
                                      reserved_bytes=batcher.total_bytes)
    if val_batcher is None:
        raise RuntimeError(f"device_data_cache={cache} refused the val split "
                           "beside the cached train split")
    report = {"train_split_gb": batcher.total_bytes / GB,
              "val_split_gb": val_batcher.total_bytes / GB,
              "windows_train": len(train_ds), "mem_after_cache": mem_stats(device)}
    print(f"cached train {report['train_split_gb']:.3f} GB + val "
          f"{report['val_split_gb']:.3f} GB; {report['windows_train']:,} training "
          "windows", flush=True)
    launches_before = kernel_launches()

    # B=256, k steps a dispatch over the cached split
    hp.batch_size = BATCH
    model = SeqGlow.init(spec, torch.Generator().manual_seed(0)).to(device)
    state = train_state.TrainState.create(model, hp, 1000, 0)
    it = index_batches(train_ds, BATCH, 1)
    train_state.run_actnorm_init(spec, state, batcher.get_batch(next(it)))
    multi = train_state.MultiStep(spec, hp, state, batcher.arrays, train_ds.seq_len,
                                  BATCH, K_DISPATCH)

    def next_block():
        return batcher.get_starts_block([next(it) for _ in range(K_DISPATCH)])["starts"]

    for _ in range(2):     # the eager warm-up, then the capture (on the card)
        m = multi(next_block())
    sync(device)
    t0, n = time.perf_counter(), 0
    while n < steps:
        m = multi(next_block())
        n += K_DISPATCH
    sync(device)
    report["b256_k8_steps_per_sec"] = n / (time.perf_counter() - t0)
    report["b256_nll_final"] = float(m["nll"][-1])
    report["mem_after_b256"] = mem_stats(device)
    print(f"B=256 k=8: {report['b256_k8_steps_per_sec']:.3f} steps/s", flush=True)

    # B=1024 beside both caches and the k-step graph
    hp.batch_size = BIG_BATCH
    state_big = train_state.TrainState.create(
        SeqGlow.init(spec, torch.Generator().manual_seed(1)).to(device), hp, 1000, 1)
    it_big = index_batches(train_ds, BIG_BATCH, 2)
    batch = batcher.get_batch(next(it_big))
    train_state.run_actnorm_init(spec, state_big, batch)
    for i in range(big_steps):
        if i:
            batch = batcher.get_batch(next(it_big))
        mb = train_state.train_step(spec, hp, state_big, batch)
    report["b1024_nll_final"] = float(mb["nll"])
    report["mem_after_b1024"] = mem_stats(device)
    del state_big, batch, mb

    # one B=256 batch gathered from the cached val split
    sel = next(val_ds.epoch_index_batches(BATCH, shuffle=False))
    with torch.no_grad():
        _, vloss, _ = seqglow.sequence_nll(spec, state.model, val_batcher.get_batch(sel))
    report["val_nll"] = float(vloss)
    report["launches"] = {name: count - launches_before[name]
                          for name, count in kernel_launches().items()}
    mem = report["mem_after_b1024"]
    if mem is not None:
        report["peak_allocated_gb"] = mem["peak_allocated"] / GB
        report["peak_gb"] = mem["peak_reserved"] / GB
        report["hbm_limit_gb"] = mem["total"] / GB
        report["headroom_gb"] = (mem["total"] - mem["peak_reserved"]) / GB
    else:
        report.update(dict.fromkeys(("peak_allocated_gb", "peak_gb", "hbm_limit_gb",
                                     "headroom_gb")))
    return report


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--big_steps", type=int, default=3)
    p.add_argument("--out", default=str(REPO / "runs" / "device_cache_scale_torch.json"))
    args = p.parse_args(argv)

    from lets_face_it_tpu_torch.bench import machine
    from lets_face_it_tpu_torch.hparams import load_hparams
    from lets_face_it_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    corpus = scale_corpus()
    corpus_s = time.perf_counter() - t0
    print(f"corpus of {N_TRAIN_CHUNKS} + {N_VAL_CHUNKS} chunks x {FRAMES_PER_CHUNK} "
          f"frames built in {corpus_s:.1f} s", flush=True)
    hp = load_hparams(REPO / "hparams" / "final_model.yaml")
    report = {**machine(device), "config": "final_model", "precision": 32,
              "corpus": f"{N_TRAIN_CHUNKS} train + {N_VAL_CHUNKS} val chunks x "
                        f"{FRAMES_PER_CHUNK} frames (data/synthetic.py in memory, "
                        f"seed {CORPUS_SEED})",
              "corpus_build_s": round(corpus_s, 1),
              **run(hp, corpus, device=device, steps=args.steps,
                    big_steps=args.big_steps)}
    bad = [k for k in ("b256_nll_final", "b1024_nll_final", "val_nll")
           if not math.isfinite(report[k])]
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1) + "\n")
    print(f"wrote {path}")
    print(json.dumps({k: v for k, v in report.items() if not k.startswith("mem_")},
                     indent=1))
    if bad:
        raise SystemExit(f"non-finite losses: {bad}")


if __name__ == "__main__":
    main()

"""Test-split evaluation (the port of ``lets_face_it_tpu/train/evaluate.py``):
the working version of the reference's bit-rotted ``test_step``
(lets_face_it_glow.py:101-142).

Per test batch:
  * teacher-forced NLL and per-frame losses (``sequence_nll``);
  * free-running generation from a zero own-face seed (``Test.seq_len``
    frames, ``sequence_sample``);
  * for each conditioned modality among p2_face, p2_speech and p1_speech: the
    NLL and the generation with that modality deranged across the batch.

The random draws (a latent sequence per generation, a permutation per
modality) come from a CPU ``torch.Generator``, or are handed in as
``EvalDraws`` so that tests can pass the JAX package's. The results are numpy
arrays saved as one ``.npz`` with the JAX package's keys
(``batch{i}/{key}``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from lets_face_it_tpu_torch.data.windows import WindowDataset
from lets_face_it_tpu_torch.hparams import HParams
from lets_face_it_tpu_torch.model import seqglow
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.train import derange

MISMATCH_MODALITIES = ("p2_face", "p2_speech", "p1_speech")


@dataclass
class EvalDraws:
    """The draws of one test batch: the free-run latents [N, B, C] (already
    scaled by ``Infer.eps``), and per deranged modality its batch
    permutation [B] and its generation's latents."""
    z_free: torch.Tensor
    perms: dict = field(default_factory=dict)
    z_mismatch: dict = field(default_factory=dict)


def eval_seq_len(hp: HParams) -> int:
    return hp.Test["seq_len"] if hasattr(hp, "Test") else hp.Validation["seq_len"]


def mismatch_modalities(hp: HParams) -> list[str]:
    return [m for m in MISMATCH_MODALITIES if hp.Conditioning[m]["history"] > 0]


def draw_eval(spec: FlowSpec, hp: HParams, batch_size: int,
              generator: torch.Generator) -> EvalDraws:
    """The batch's draws from a CPU ``generator``: the free-run latents, then
    per modality its permutation and its generation's latents."""
    n = eval_seq_len(hp) - spec.cond.longest_history
    eps = float(hp.Infer["eps"])

    def z():
        return torch.randn((n, batch_size, spec.channels), generator=generator) * eps

    draws = EvalDraws(z_free=z())
    for m in mismatch_modalities(hp):
        draws.perms[m] = torch.randperm(batch_size, generator=generator)
        draws.z_mismatch[m] = z()
    return draws


def _zero_seed(batch, start: int):
    """Conditioning data with the own-face seed zeroed and cut to the seed
    frames (lets_face_it_glow.py:106-113)."""
    out = dict(batch)
    out["p1_face"] = torch.zeros_like(batch["p1_face"][:, :start])
    return out


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def evaluate_batch(spec: FlowSpec, model, hp: HParams, batch, *,
                   generator: torch.Generator | None = None,
                   draws: EvalDraws | None = None) -> dict:
    """One test batch (tensors on the model's device) -> {key: numpy array}.
    The draws are ``draws`` when given, else drawn from ``generator``."""
    seq_len = eval_seq_len(hp)
    start = spec.cond.longest_history
    if draws is None:
        draws = draw_eval(spec, hp, batch["p1_face"].shape[0], generator)

    out = {}
    _, loss, losses = seqglow.sequence_nll(spec, model, batch)
    out["test_loss"] = _np(loss)
    out["test_losses"] = _np(losses)

    predicted = seqglow.sequence_sample(spec, model, _zero_seed(batch, start),
                                        seq_len, z_seq=draws.z_free)
    out["predicted_prop_seq"] = _np(predicted)
    out["gt_seq"] = _np(batch["p1_face"][:, -predicted.shape[1]:])

    for modality in mismatch_modalities(hp):
        deranged = derange.derange_batch(batch, [modality],
                                         perm=draws.perms[modality])
        _, mis_loss, mis_losses = seqglow.sequence_nll(spec, model, deranged)
        out[f"nll_mismatched_{modality}"] = _np(mis_loss)
        out[f"losses_mismatched_{modality}"] = _np(mis_losses)
        mis_pred = seqglow.sequence_sample(spec, model, _zero_seed(deranged, start),
                                           seq_len, z_seq=draws.z_mismatch[modality])
        out[f"predicted_mismatch_{modality}_seq"] = _np(mis_pred)
    return out


def load_test_split(hp: HParams, corpus=None) -> WindowDataset:
    """The test split's windows of ``Test.seq_len``: from ``corpus`` in memory
    when given, else from the HDF5 store under ``hp.dataset_root``."""
    args = (hp.Data, hp.Conditioning, eval_seq_len(hp))
    if corpus is not None:
        return WindowDataset.from_chunks(corpus, "test", *args)
    return WindowDataset.from_file(Path(hp.dataset_root) / hp.Data["file_name"],
                                   "test", *args)


def save_results(results: list[dict], output_file) -> Path:
    """The per-batch results as one ``.npz``, keys ``batch{i}/{key}``."""
    flat = {f"batch{i}/{k}": v for i, res in enumerate(results)
            for k, v in res.items()}
    path = Path(output_file)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **flat)
    return path


def run_test(hp: HParams, model, *, output_file=None, seed: int = 1234,
             max_batches: int | None = None, corpus=None) -> list[dict]:
    """Evaluate ``model`` (on its device) on the test split, batches in order
    (the last one ragged); the draws come from a CPU generator seeded with
    ``seed``. Returns the per-batch result dicts and saves them when
    ``output_file`` is given."""
    spec = FlowSpec.build(hp)
    if not hasattr(hp, "Test"):
        hp.Test = {"seq_len": hp.Validation["seq_len"]}
    ds = load_test_split(hp, corpus)
    device = next(model.parameters()).device
    generator = torch.Generator().manual_seed(seed)
    results = []
    for i, batch in enumerate(ds.epoch_batches(hp.batch_size, shuffle=False)):
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        results.append(evaluate_batch(spec, model, hp, batch, generator=generator))
        if max_batches is not None and i + 1 >= max_batches:
            break
    if output_file is not None:
        save_results(results, output_file)
    return results


def summarize(results: list[dict]) -> dict:
    """Scalar metrics averaged over batches (the paper's Table 1 numbers: the
    mean NLL, matched and per-modality mismatched)."""
    keys = {k for res in results for k in res
            if k == "test_loss" or k.startswith("nll_mismatched")}
    return {k: float(np.mean([float(res[k]) for res in results if k in res]))
            for k in sorted(keys)}

"""Guards of the PyTorch port: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU when no GPU is present, its
weights round-trip through the reference's names bit for bit, and
chip_smoke.py refuses to report without a GPU or outside a checkout."""

import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lets_face_it_tpu.sample.torch_import import (export_state_dict,
                                                  import_torch_checkpoint)
from lets_face_it_tpu_torch import generate as cli
from lets_face_it_tpu_torch.sample.generate import Generator
from lets_face_it_tpu_torch.sample.streaming import StreamingGenerator
from lets_face_it_tpu_torch.sample.weights import (load_state_dict,
                                                   model_from_reference,
                                                   state_dict_reference)

from test_torch_port_common import (jax_params, port_hp, port_model, specs,
                                    tiny_hp, train_hp)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lets_face_it_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m == "lets_face_it_tpu" or m.startswith("lets_face_it_tpu.")]
# absent on GPU hosts: imported only where used, never at module import
optional = [m for m in ("tensorboardX", "comet_ml", "cv2", "h5py", "triton")
            if m in sys.modules]
print(len(names), bad, optional)
assert not bad, bad
assert not optional, optional
"""


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port imports, without JAX, the JAX package, or
    (at module import) the optional TensorBoard, Comet, OpenCV, HDF5 and
    Triton packages."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 30, out.stdout


def test_chip_smoke_imports_no_jax():
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "lets_face_it_tpu" not in roots


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _ckpt(tmp_path):
    spec, pspec = specs(tiny_hp())
    model = port_model(jax_params(spec), pspec)
    path = tmp_path / "w.pt"
    torch.save(state_dict_reference(model), path)
    return pspec, model, path


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    pspec, model, path = _ckpt(tmp_path)
    hp = port_hp(tiny_hp())
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(hp, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator.from_checkpoint(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingGenerator(pspec, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--ckpt", str(path), "--out", str(tmp_path / "o.npy")])


def test_training_entry_points_raise_without_cuda(no_cuda, tmp_path):
    """The trainer CLI and ``train`` default to the GPU and raise without
    one, before any work."""
    import yaml

    from lets_face_it_tpu_torch.train import __main__ as train_cli
    from lets_face_it_tpu_torch.train.loop import synthetic_corpus, train

    hp = port_hp(train_hp())
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump({k: v for k, v in vars(hp).items()
                                   if k != "config_name"}))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([str(cfg), "--synthetic-data", "--max_steps", "1",
                        "--ckpt_dir", str(tmp_path / "ck")])
    with pytest.raises(RuntimeError, match="CUDA"):
        train(hp, corpus=synthetic_corpus(hp, 0), max_steps=1)
    assert not (tmp_path / "ck").exists()


def test_cli_runs_on_cpu_when_asked(tmp_path, monkeypatch):
    """The CLI with --device cpu: a Lightning-style .ckpt with its hparams."""
    spec, pspec = specs(tiny_hp())
    model = port_model(jax_params(spec), pspec)
    hp = tiny_hp()
    hp.dataset_root = str(tmp_path)
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": state_dict_reference(model),
                "hyper_parameters": vars(hp)}, ckpt)
    out = tmp_path / "gen.npy"
    cli.main(["--ckpt", str(ckpt), "--out", str(out), "--seq_len", "12",
              "--device", "cpu"])
    frames = np.load(out)
    assert frames.shape == (1, 12 - pspec.cond.longest_history, 106)
    assert np.isfinite(frames).all()


def test_weights_round_trip_bit_exact():
    """JAX params -> export_state_dict -> port -> state_dict_reference ->
    JAX import_torch_checkpoint gives back the same bits."""
    spec, pspec = specs(tiny_hp())
    params = jax_params(spec, seed=2)
    state = export_state_dict(params, spec)
    model = model_from_reference(state, pspec)
    back = state_dict_reference(model)
    assert set(back) == set(state)
    for name, value in state.items():
        np.testing.assert_array_equal(back[name].numpy(), value, err_msg=name)
    again = import_torch_checkpoint({k: v.numpy() for k, v in back.items()}, spec)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_state_dict_in_place_equals_from_jax_params():
    spec, pspec = specs(tiny_hp())
    params = jax_params(spec, seed=3)
    direct = port_model(params, pspec)
    other = port_model(jax_params(spec, seed=4), pspec)
    load_state_dict(other, export_state_dict(params, spec))
    for (n1, p1), (n2, p2) in zip(direct.named_parameters(),
                                  other.named_parameters()):
        assert n1 == n2
        np.testing.assert_array_equal(p1.detach().numpy(), p2.detach().numpy())
    bad = export_state_dict(params, spec)
    bad.pop("seq_glow.glow.flow.layers.0.actnorm.bias")
    with pytest.raises(KeyError, match="actnorm.bias"):
        load_state_dict(other, bad)


def test_chip_smoke_refuses_without_gpu_and_alone(tmp_path):
    """Here (no GPU) the script fails and prints no result; copied alone into
    an empty directory it fails before touching torch."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout

"""The port's configuration layer against the JAX package's: hparams loading,
``FlowSpec.build`` field by field for every shipped config, and the small
pure-Python helpers the port keeps its own copies of."""

import dataclasses
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from lets_face_it_tpu import hparams as jhparams
from lets_face_it_tpu.data import windows as jwindows
from lets_face_it_tpu.model.spec import FlowSpec
from lets_face_it_tpu.utils import misc as jmisc
from lets_face_it_tpu_torch import hparams as phparams
from lets_face_it_tpu_torch.data import windows as pwindows
from lets_face_it_tpu_torch.model.spec import FlowSpec as PortFlowSpec
from lets_face_it_tpu_torch.utils import misc as pmisc

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "hparams").glob("*.yaml"))


def test_all_configs_found():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_flowspec_build_matches_jax_fieldwise(path, tmp_path):
    jhp = jhparams.load_hparams(path, dataset_root=tmp_path)
    php = phparams.load_hparams(path, dataset_root=tmp_path)
    assert vars(php) == vars(jhp)
    jspec, pspec = FlowSpec.build(jhp), PortFlowSpec.build(php)
    for field in dataclasses.fields(pspec):
        got, want = getattr(pspec, field.name), getattr(jspec, field.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), field.name
        else:
            assert got == want, field.name
    assert pspec.z1_dim == jspec.z1_dim
    assert pspec.coupling_out_dim == jspec.coupling_out_dim
    assert (phparams.longest_history(php.Conditioning)
            == jhparams.longest_history(jhp.Conditioning))


def test_validate_hparams_rejects_like_jax(tmp_path):
    for mod in (jhparams, phparams):
        hp = mod.load_hparams(REPO / "hparams" / "final_model.yaml",
                              dataset_root=tmp_path)
        hp.Conditioning["p1_face"]["dim"] = 7
        with pytest.raises(AssertionError, match="p1_face dim"):
            mod.validate_hparams(hp)


@pytest.mark.parametrize("offset", [0, 136])
def test_face_indices_match(offset):
    assert (pmisc.get_face_indicies(50, 3, 3, offset)
            == jmisc.get_face_indicies(50, 3, 3, offset))


def test_standardization_helpers_match(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "stats.h5"
    with h5py.File(path, "w") as f:
        for kind, d in (("flame_expression", 100), ("flame_jaw", 3),
                        ("flame_neck", 3)):
            f.create_dataset(f"means/{kind}", data=rng.standard_normal(d))
            f.create_dataset(f"stds/{kind}", data=rng.random(d) + 0.5)
    with h5py.File(path, "r") as f:
        jm, js = jwindows.load_standardization(f)
        pm, ps = pwindows.load_standardization(f)
    for a, b in zip(jwindows.face_means_stds(jm, js, 50),
                    pwindows.face_means_stds(pm, ps, 50)):
        np.testing.assert_array_equal(a, b)

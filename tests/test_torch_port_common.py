"""Shared set-up for the PyTorch port's parity tests, and the parameter-tree
tests.

Every port test file compares ``lets_face_it_tpu_torch`` with the JAX package
on the CPU: inputs are made with numpy from a seed and handed to both sides;
JAX runs at ``highest`` matmul precision (tests/conftest.py) and torch with
TF32 off. Default tolerance: atol 2e-4, rtol 1e-4 (the JAX kernel tests').
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.model import FlowSpec, flow, init_seqglow
from lets_face_it_tpu_torch.hparams import HParams as PortHParams
from lets_face_it_tpu_torch.model.seqglow import SeqGlow
from lets_face_it_tpu_torch.model.spec import FlowSpec as PortFlowSpec
from lets_face_it_tpu_torch.sample.weights import from_jax_params

from conftest import tiny_hparams

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ATOL, RTOL = 2e-4, 1e-4


def tiny_hp(p1_dim: int = 12):
    """conftest's tiny config with own-face conditioning on (12-D, 'none'
    encoder, history 3), as tests/test_pallas_flow.py uses it."""
    hp = tiny_hparams()
    hp.Conditioning["p1_face"]["dim"] = p1_dim
    return hp


def train_hp(p1_dim: int = 16):
    """The tiny config at a width inside the training kernels' envelope
    (every product width a multiple of 4): 10 expression dims, so C=16 and
    Z1=8, with 16-D own-face and interlocutor faces."""
    hp = tiny_hparams()
    hp.Data["expression_dim"] = 10
    hp.Conditioning["p1_face"]["dim"] = p1_dim
    hp.Conditioning["p2_face"]["dim"] = 16
    return hp


def port_hp(hp):
    """The same config as the port's HParams."""
    out = PortHParams(**vars(hp))
    out.config_name = hp.config_name
    return out


def specs(hp):
    """(JAX FlowSpec, port FlowSpec) of one config."""
    return FlowSpec.build(hp), PortFlowSpec.build(port_hp(hp))


def jax_params(spec, seed: int = 0, scale: float = 0.05):
    """JAX init with every trained flow leaf perturbed by scale * N(0, 1), so
    coupling heads and scales are non-trivial (tests/test_pallas_flow.py)."""
    params = init_seqglow(jax.random.PRNGKey(seed), spec)
    mask = flow.trainable_mask(params.flow)
    pflow = jax.tree.map(
        lambda x, m: x + scale * jax.random.normal(jax.random.PRNGKey(seed + 9),
                                                   x.shape)
        if m and jnp.issubdtype(x.dtype, jnp.floating) else x,
        params.flow, mask)
    return params._replace(flow=pflow)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_model(params, port_spec) -> SeqGlow:
    """The port's model holding the JAX parameters."""
    return from_jax_params(numpy_tree(params.encoder), numpy_tree(params.flow),
                           port_spec)


def assert_close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p1_dim", [12, 0])
def test_port_init_has_jax_tree_and_shapes(p1_dim):
    """The port's fresh SeqGlow carries exactly the JAX parameter tree: same
    keys, same shapes, same dtypes class (float leaves)."""
    spec, pspec = specs(tiny_hp(p1_dim))
    jparams = init_seqglow(jax.random.PRNGKey(0), spec)
    model = SeqGlow.init(pspec, torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams.flow)[0]}
    got = {"".join(f"['{k}']" for k in name.split(".")): tuple(p.shape)
           for name, p in model.flow.named_parameters()}
    assert got == want
    enc_want = {jax.tree_util.keystr(path): leaf.shape for path, leaf in
                jax.tree_util.tree_flatten_with_path(jparams.encoder)[0]}
    enc_got = {"".join(f"['{k}']" for k in name.split(".")): tuple(p.shape)
               for name, p in model.encoder.named_parameters()}
    assert enc_got == enc_want


def test_port_init_invconv_is_orthogonal_lu():
    """The port's invconv init (numpy QR + scipy LU in float64) gives an
    orthogonal W = P L U, frozen P/sign_s and trained l/log_s/u."""
    _, pspec = specs(tiny_hp())
    model = SeqGlow.init(pspec, torch.Generator().manual_seed(3))
    from lets_face_it_tpu_torch.core import ops as pops
    from lets_face_it_tpu_torch.model.flow import tree_index

    w = pops.invconv_weight(tree_index(model.flow["perm"], 0)).detach()
    np.testing.assert_allclose(w @ w.T, np.eye(pspec.channels), atol=1e-5)
    frozen = {n for n, p in model.flow.named_parameters() if not p.requires_grad}
    assert frozen == {"perm.p", "perm.sign_s"}


def test_from_jax_params_keeps_values_bitwise():
    spec, pspec = specs(tiny_hp())
    params = jax_params(spec)
    model = port_model(params, pspec)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params.flow)[0]:
        keys = [p.key for p in path]
        np.testing.assert_array_equal(
            model.flow[keys[0]][keys[1]].detach().numpy(), np.asarray(leaf))


def test_spec_dataclasses_match_jax_fieldwise():
    """The port's copies of the spec dataclasses have the JAX fields, minus
    the JAX-only scan knobs."""
    from lets_face_it_tpu.model import spec as jspec
    from lets_face_it_tpu_torch.model import spec as pspec_mod

    for name in ("EncSpec", "CondSpec"):
        assert ([f.name for f in dataclasses.fields(getattr(jspec, name))]
                == [f.name for f in dataclasses.fields(getattr(pspec_mod, name))])
    jf = [f.name for f in dataclasses.fields(jspec.FlowSpec)]
    pf = [f.name for f in dataclasses.fields(pspec_mod.FlowSpec)]
    assert pf == [f for f in jf if f not in ("remat", "step_unroll")]

"""The port's training-kernel module (lets_face_it_tpu_torch/ops/train_kernels.py)
against the JAX package's Pallas training kernels, run in interpret mode on
the CPU, and against its XLA scan.

On CPU tensors the wrappers run their plain PyTorch versions under the
autograd Function; the CUDA kernels themselves (``cond_gates``, ``seq_fwd``,
``seq_bwd``) are held against those plain versions on the card by
``test_cuda_training_kernels_match_plain`` (marked ``requires_cuda``) and by
chip_smoke.py.

Tolerances: values atol 1e-5 / rtol 1e-5 (logdet atol 1e-4), gradients atol
2e-5 / rtol 1e-4: the JAX kernel tests' own (tests/test_pallas_train.py),
float32 in another summation order. ``gradcheck`` runs in float64 at its
default tolerances.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lets_face_it_tpu.core import ops as jops
from lets_face_it_tpu.model import flow as jflow
from lets_face_it_tpu.ops import pallas_train
from lets_face_it_tpu_torch.model import flow as pflow
from lets_face_it_tpu_torch.model.spec import FlowSpec as PortFlowSpec
from lets_face_it_tpu_torch.ops import train_kernels as tk
from lets_face_it_tpu_torch.ops.flow_kernels import MAX_SMEM_BYTES
from lets_face_it_tpu_torch.ops.flow_kernels import MODES as fk_modes

from test_torch_port_common import (assert_close, jax_params, port_hp,
                                    port_model, specs, tiny_hp, train_hp)

REPO = Path(__file__).resolve().parent.parent
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VAL_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(spec, n=5, b=4, seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, b, spec.channels)).astype(np.float32)
    cond = rng.standard_normal((n, spec.n_steps, b, spec.cond.cond_dim)).astype(np.float32)
    states0 = (0.1 * rng.standard_normal(
        (spec.n_steps, b, spec.hidden_channels))).astype(np.float32)
    return xs, cond, states0


def _objective(logdet, z, new_states, gaussian_logp, ln2):
    """Touches every output so that every cotangent path is exercised
    (tests/test_pallas_train.py:179-185)."""
    return ((-(logdet + gaussian_logp(z)) / ln2).mean()
            + 0.05 * (new_states ** 2).sum() + 0.01 * (z ** 2).sum())


def _jax_xla(spec, pflow_params, xs, cond, states0):
    def step(states, inp):
        x_t, proj_t = inp
        z, logdet, states, scales = jflow.frame_fwd(
            spec, pflow_params, x_t, None, states, collect_scales=True,
            cond_projs=proj_t)
        return states, (z, logdet, scales)

    new_states, (z, logdet, scales) = jax.lax.scan(step, states0, (xs, cond))
    return z, logdet, new_states, scales


def _jax_pallas(spec, pflow_params, xs, cond, states0):
    return pallas_train.flow_sequence_fused(
        spec, pflow_params, xs, cond, states0, bt_fwd=2, bt_bwd=2,
        interpret=True)


@functools.cache
def _jax_reference(which: str):
    """(outputs, gradients on (flow, xs, cond, states0)) of one JAX path."""
    spec, _ = specs(train_hp())
    params = jax_params(spec)
    run = _jax_pallas if which == "pallas" else _jax_xla

    def loss(pf, xs, cond, st0):
        z, logdet, new_states, scales = run(spec, pf, xs, cond, st0)
        return (_objective(logdet, z, new_states, jops.gaussian_logp, jops.LN2),
                (z, logdet, new_states, scales))

    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(
        params.flow, *map(jnp.asarray, _inputs(spec)))
    return jax.tree.map(np.asarray, outs), jax.tree.map(np.asarray, grads)


def _port_run(spec, pspec, params):
    model = port_model(params, pspec)
    xs, cond, states0 = (torch.tensor(a, requires_grad=True) for a in _inputs(spec))
    z, logdet, new_states, scales = tk.flow_sequence_fused(
        pspec, model.flow, xs, cond, states0)
    loss = _objective(logdet, z, new_states,
                      lambda v: (-0.5 * (v ** 2 + jops.LOG2PI)).sum(-1), jops.LN2)
    loss.backward()
    return model, (z, logdet, new_states, scales), (xs, cond, states0)


@pytest.mark.parametrize("which", ["pallas", "xla"])
def test_flow_sequence_fused_matches_jax(which):
    """Values and gradients (every trained flow leaf, xs, cond_seq, states0)
    of the port's Function on the CPU against the JAX Pallas kernel pair in
    interpret mode and against the XLA scan."""
    spec, pspec = specs(train_hp())
    assert tk.train_supported(pspec)
    params = jax_params(spec)
    (jz, jld, jst, jsc), (gflow, gxs, gcond, gst0) = _jax_reference(which)
    model, (z, logdet, new_states, scales), inputs = _port_run(spec, pspec, params)
    assert tk.seq_fwd.launches == 0 and tk.seq_bwd.launches == 0
    assert tk.cond_gates.launches == 0
    assert_close(z, jz, **VAL_TOL)
    assert_close(logdet, jld, atol=1e-4, rtol=1e-5)
    assert_close(new_states, jst, **VAL_TOL)
    assert_close(scales, jsc, atol=1e-6, rtol=0)
    for (path, leaf) in jax.tree_util.tree_flatten_with_path(gflow)[0]:
        group, name = (p.key for p in path)
        param = model.flow[group][name]
        if not param.requires_grad:          # frozen P and sign(s)
            continue
        got = param.grad if param.grad is not None else torch.zeros_like(param)
        assert_close(got, leaf, **GRAD_TOL)
    for tensor, want in zip(inputs, (gxs, gcond, gst0)):
        assert_close(tensor.grad, want, **GRAD_TOL)


def test_function_gradcheck_float64():
    """The hand-derived backward of the plain path against finite
    differences, in float64 (torch.autograd.gradcheck)."""
    hp = train_hp()
    hp.Glow["K"] = 2
    hp.Glow["hidden_channels"] = 4
    hp.Conditioning["cond_dim"] = 4
    _, pspec = specs(hp)
    model = pflow.init_flow(torch.Generator().manual_seed(0), pspec)
    rng = np.random.default_rng(3)

    def leaf(x, scale=0.3):
        x = x.double() + scale * torch.as_tensor(rng.standard_normal(x.shape))
        return x.requires_grad_()

    an_bias, logs = leaf(model["actnorm"]["bias"]), leaf(model["actnorm"]["logs"])
    perm = {k: v.double() for k, v in model["perm"].items()}
    rnn_p = {k: leaf(v) for k, v in model["rnn"].items()}
    out_p = {k: leaf(v) for k, v in model["out"].items()}
    n, b = 2, 2
    xs = leaf(torch.zeros(n, b, pspec.channels), 1.0)
    cond = leaf(torch.zeros(n, pspec.n_steps, b, pspec.cond.cond_dim), 1.0)
    states0 = leaf(torch.zeros(pspec.n_steps, b, pspec.hidden_channels))

    def run(an_bias, logs, w_ih, w_hh, b_ih, b_hh, out_w, out_b, out_logs,
            xs, cond, states0):
        flow_params = {"actnorm": {"bias": an_bias, "logs": logs}, "perm": perm,
                       "rnn": {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b_ih,
                               "b_hh": b_hh},
                       "out": {"w": out_w, "b": out_b, "logs": out_logs}}
        return tk.flow_sequence_fused(pspec, flow_params, xs, cond, states0)

    args = (an_bias, logs, rnn_p["w_ih"], rnn_p["w_hh"], rnn_p["b_ih"],
            rnn_p["b_hh"], out_p["w"], out_p["b"], out_p["logs"], xs, cond,
            states0)
    assert torch.autograd.gradcheck(run, args)


def test_prepare_train_weights_matches_jax():
    """W = P L U, exp(logs), transposed GRU weights and the folded head agree
    with the JAX package's preparation (whose w_ih_t carries Mosaic padding
    rows, all zero)."""
    spec, pspec = specs(train_hp())
    params = jax_params(spec)
    jw = pallas_train.prepare_train_weights(spec, params.flow)
    pw = tk.prepare_train_weights(pspec, port_model(params, pspec).flow)
    rows = pw.w_ih_t.shape[1]
    np.testing.assert_array_equal(pw.w_ih_t.detach().numpy(),
                                  np.asarray(jw.w_ih_t)[:, :rows])
    assert not np.asarray(jw.w_ih_t)[:, rows:].any()
    for name in ("an_bias", "w_hh_t", "b_ih", "b_hh"):
        np.testing.assert_array_equal(getattr(pw, name).detach().numpy(),
                                      np.asarray(getattr(jw, name)))
    for name in ("w", "an_scale", "out_w_t", "out_b"):
        assert_close(getattr(pw, name), getattr(jw, name), atol=1e-6, rtol=1e-6)
    assert_close(tk.logdet_const(pspec, port_model(params, pspec).flow),
                 pallas_train.logdet_const(spec, params.flow), atol=1e-5, rtol=1e-6)


def test_envelope_and_guards():
    assert tk.train_supported(PortFlowSpec.build(port_hp(train_hp())))
    # C=12 gives Z1=6: not a multiple of 4
    assert not tk.train_supported(PortFlowSpec.build(port_hp(tiny_hp())))
    hp = train_hp()
    hp.Glow["rnn_type"] = "lstm"
    assert not tk.train_supported(PortFlowSpec.build(port_hp(hp)))
    spec, pspec = specs(train_hp())
    model = port_model(jax_params(spec), pspec)
    xs, cond, states0 = (torch.as_tensor(a) for a in _inputs(spec, n=2, b=2))
    # a reduced precision runs as its plain twin at that mode; an unknown
    # one is refused
    with torch.no_grad():
        z_seq, *_ = tk.flow_sequence_fused(pspec, model.flow, xs, cond, states0,
                                           precision="high")
        tw = tk.prepare_train_weights(pspec, model.flow)
        z_ref = tk.seq_fwd_ref(pspec, tw, xs, cond, states0, fk_modes["high"])[0]
    assert torch.equal(z_seq, z_ref)
    with pytest.raises(ValueError, match="precision"):
        tk.flow_sequence_fused(pspec, model.flow, xs, cond, states0,
                               precision="bf16")
    tw = tk.prepare_train_weights(pspec, model.flow)
    with pytest.raises(ValueError, match="device"):
        tk.seq_fwd(pspec, tw, xs.to("meta"), cond, states0)
    _, tiny_spec = specs(tiny_hp())
    with pytest.raises(ValueError, match="envelope"):
        tk.seq_fwd(tiny_spec, tw, xs, cond, states0)


def test_cond_gates_and_serial_plain_match_pallas_fwd_call():
    """``cond_gates_ref`` followed by the plain serial chain (the port's
    ``seq_fwd_ref``) against the JAX forward kernel ``_seq_fwd_call`` in
    interpret mode, on the same prepared weights and inputs."""
    spec, pspec = specs(train_hp())
    params = jax_params(spec)
    xs, cond, states0 = _inputs(spec)
    jtw = pallas_train.prepare_train_weights(spec, params.flow)
    want = pallas_train._seq_fwd_call(spec, 2, True, jax.lax.Precision.HIGHEST,
                                      jtw, *map(jnp.asarray, (xs, cond, states0)))
    tw = tk.prepare_train_weights(pspec, port_model(params, pspec).flow)
    with torch.no_grad():
        got = tk.seq_fwd_ref(pspec, tw, *map(torch.as_tensor, (xs, cond, states0)))
    assert len(got) == 5
    for a, w in zip(got[:4], want):
        assert_close(a, np.asarray(w), **VAL_TOL)


def _jax_cond_gates(spec, params, cond):
    jtw = pallas_train.prepare_train_weights(spec, params.flow)
    z1d, cdim = spec.z1_dim, spec.cond.cond_dim
    gc = jnp.einsum("nkbi,kig->nkbg", jax.nn.leaky_relu(jnp.asarray(cond), 0.01),
                    jtw.w_ih_t[:, z1d:z1d + cdim],
                    precision=jax.lax.Precision.HIGHEST)
    return np.asarray(gc + jtw.b_ih[None, :, None, :])


def test_function_saves_cond_gates_residual():
    """The Function's saved ``gc`` residual equals leaky_relu(cond) @
    w_ih_t[:, Z1:] + b_ih computed in JAX, and ``cond_gates`` on CPU tensors
    is its plain version (no launch counted)."""
    spec, pspec = specs(train_hp())
    params = jax_params(spec)
    model = port_model(params, pspec)
    xs, cond, states0 = (torch.tensor(a, requires_grad=True) for a in _inputs(spec))
    z, _, _, _ = tk.flow_sequence_fused(pspec, model.flow, xs, cond, states0)
    saved = z.grad_fn.saved_tensors
    gc = saved[len(tk.TrainWeights._fields) + 1]
    want = _jax_cond_gates(spec, params, cond.detach().numpy())
    assert gc.shape == want.shape
    assert_close(gc, want, **VAL_TOL)
    launches = tk.cond_gates.launches
    tw = tk.prepare_train_weights(pspec, model.flow)
    with torch.no_grad():
        assert_close(tk.cond_gates(pspec, tw, cond.detach()), want, **VAL_TOL)
    assert tk.cond_gates.launches == launches


def test_final_model_inside_training_envelope():
    """final_model's one-row backward block (ring of three slots, K state
    cotangents, buffers, one slice of partial sums) fits one block's shared
    memory with room for the streamed layout."""
    from lets_face_it_tpu_torch.hparams import load_hparams

    hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root="unused")
    pspec = PortFlowSpec.build(hp)
    assert tk.train_supported(pspec)
    assert tk.train_smem_bytes(pspec) < MAX_SMEM_BYTES // 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b", [5, 33])
def test_cuda_training_kernels_match_plain(cuda_device, b):
    """The three CUDA training kernels against their plain versions on the
    card; B=5 and B=33 leave the last cluster of the serial kernels partly
    padding."""
    spec, pspec = specs(train_hp())
    model = port_model(jax_params(spec), pspec).to(cuda_device)
    xs, cond, states0 = (torch.as_tensor(a, device=cuda_device)
                         for a in _inputs(spec, n=5, b=b))
    with torch.no_grad():
        tw = tk.prepare_train_weights(pspec, model.flow)
        assert_close(tk.cond_gates(pspec, tw, cond).cpu(),
                     tk.cond_gates_ref(pspec, tw, cond).cpu().numpy(), **VAL_TOL)
        got = tk.seq_fwd(pspec, tw, xs, cond, states0)
        want = tk.seq_fwd_ref(pspec, tw, xs, cond, states0)
        for a, w in zip(got, want):
            assert_close(a.cpu(), w.cpu().numpy(), **VAL_TOL)
        _, _, zs_res, states_res, gc = want
        hprev = torch.cat([states0[None], states_res[:-1]])
        g = torch.Generator(device=cuda_device).manual_seed(0)
        cot = (torch.randn(xs.shape, generator=g, device=cuda_device),
               torch.randn(want[1].shape, generator=g, device=cuda_device),
               torch.randn(states0.shape, generator=g, device=cuda_device))
        got = tk.seq_bwd(pspec, tw, gc, zs_res, hprev, *cot)
        want = tk.seq_bwd_ref(pspec, tw, gc, zs_res, hprev, *cot)
        for a, w in zip(got, want):
            assert_close(a.cpu(), w.cpu().numpy(), **GRAD_TOL)

"""The port's batched L-BFGS (``lets_face_it_tpu_torch/features/lbfgs.py``)
against ``optax.lbfgs()`` as the JAX package's FLAME fit runs it: a ``vmap``
over rows of a ``lax.scan`` of value_and_grad + update, the loss kept from
the start of each step (``features/flame_fit.py::_lbfgs_solve``).

Three problems, each a batch of rows that differ: convex quadratics, the
Rosenbrock function (curvature changes, zoom steps taken), and a barrier
sum(3x - log x) whose first trial steps leave the domain (NaN values: the
line search's decrease error turns them to inf and it backs off).

Tolerances: in float64 the port follows optax iterate by iterate to 1e-10
over 12-40 steps (read 1.1e-11 after 40 Rosenbrock steps: the two differ
only in summation order). In float32 the first steps agree to atol 1e-5 on
the iterates (read 4.1e-06 after 8 quadratic steps) and rtol 1e-5 on the
losses; later float32 steps are not held: once the values of a line
search's trials differ by a few float32 ulps (the barrier by its fourth
step: 4.7e-04 apart after 5), its branches follow rounding, as they do
between two orders of the same sum. A row's result is the same bits alone
and in a batch of rows whose line searches end at other times.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lets_face_it_tpu_torch.features.lbfgs import lbfgs_solve, value_and_grad

N, D = 6, 5


def _problem(name: str, dtype):
    """(jax per-row objective f(x, a) -> scalar, torch objective over rows
    [N, D] -> [N], x0 [N, D], per-row data a [N, ...])."""
    rng = np.random.default_rng({"quad": 0, "rosen": 1, "barrier": 2}[name])
    if name == "quad":
        m = rng.standard_normal((N, D, D))
        a = (m @ m.transpose(0, 2, 1) + 0.5 * np.eye(D)).astype(dtype)
        b = rng.standard_normal((N, D)).astype(dtype)
        x0 = rng.standard_normal((N, D)).astype(dtype)
        at, bt = torch.as_tensor(a), torch.as_tensor(b)
        return ((lambda x, ab: 0.5 * x @ ab[0] @ x - ab[1] @ x),
                (lambda x: 0.5 * torch.einsum("nd,nde,ne->n", x, at, x)
                 - (bt * x).sum(-1)),
                x0, (a, b))
    if name == "rosen":
        x0 = (0.5 * rng.standard_normal((N, D))).astype(dtype)
        w = np.linspace(1.0, 100.0, N).astype(dtype)
        wt = torch.as_tensor(w)
        return ((lambda x, w: jnp.sum(w * (x[1:] - x[:-1] ** 2) ** 2
                                      + (1 - x[:-1]) ** 2)),
                (lambda x: (wt[:, None] * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                            + (1 - x[:, :-1]) ** 2).sum(-1)),
                x0, w)
    x0 = rng.uniform(2.0, 6.0, (N, D)).astype(dtype)
    return ((lambda x, _: jnp.sum(3.0 * x - jnp.log(x))),
            (lambda x: (3.0 * x - torch.log(x)).sum(-1)),
            x0, np.zeros(N, dtype))


def _optax_solve(f, x0, data, n_steps):
    """The JAX package's ``_lbfgs_solve`` on each row: (x, loss at the start
    of the last step)."""
    def run(x0, a):
        opt = optax.lbfgs()
        fn = lambda x: f(x, a)  # noqa: E731

        def step(carry, _):
            x, state = carry
            loss, grads = jax.value_and_grad(fn)(x)
            updates, state = opt.update(grads, state, x, value=loss,
                                        grad=grads, value_fn=fn)
            return (optax.apply_updates(x, updates), state), loss

        (x, _), losses = jax.lax.scan(step, (x0, opt.init(x0)), None,
                                      length=n_steps)
        return x, losses[-1]

    return [np.asarray(v) for v in jax.jit(jax.vmap(run))(
        jnp.asarray(x0), jax.tree.map(jnp.asarray, data))]


@pytest.mark.parametrize("name,n_steps", [
    (name, k) for name in ("quad", "rosen") for k in (1, 2, 3, 5, 8)]
    + [("barrier", k) for k in (1, 2, 3)])
def test_first_steps_match_optax_float32(name, n_steps):
    f_j, f_t, x0, data = _problem(name, np.float32)
    x_ref, loss_ref = _optax_solve(f_j, x0, data, n_steps)
    res = lbfgs_solve(f_t, torch.as_tensor(x0), n_steps)
    assert res.x.dtype == torch.float32 and res.evals >= 2 * n_steps
    np.testing.assert_allclose(res.x.numpy(), x_ref, atol=1e-5)
    np.testing.assert_allclose(res.loss.numpy(), loss_ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,n_steps", [("quad", 20), ("rosen", 40),
                                          ("barrier", 12)])
def test_iterates_match_optax_float64(name, n_steps):
    with jax.enable_x64(True):
        f_j, f_t, x0, data = _problem(name, np.float64)
        for k in (1, n_steps // 2, n_steps):
            x_ref, loss_ref = _optax_solve(f_j, x0, data, k)
            res = lbfgs_solve(f_t, torch.as_tensor(x0), k)
            np.testing.assert_allclose(res.x.numpy(), x_ref, rtol=1e-10,
                                       atol=1e-10, err_msg=f"step {k}")
            np.testing.assert_allclose(res.loss.numpy(), loss_ref, rtol=1e-10,
                                       atol=1e-10, err_msg=f"step {k}")


def test_loss_is_taken_at_the_start_of_the_last_step():
    _, f_t, x0, _ = _problem("quad", np.float32)
    x = torch.as_tensor(x0)
    one = lbfgs_solve(f_t, x, 1)
    assert torch.equal(one.loss, f_t(x))
    two = lbfgs_solve(f_t, x, 2)
    assert torch.equal(two.loss, f_t(one.x))
    assert (f_t(two.x) < two.loss).all()


def test_a_row_does_not_depend_on_its_batch():
    """Rows whose line searches take different numbers of trials: each row
    alone gives the bits it gives inside the batch."""
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(rng.standard_normal((N, D)).astype(np.float32))
    w = torch.linspace(0.0, 1.0, N)[:, None]
    scale = torch.arange(1.0, D + 1.0)

    def mixed(w):
        def f(x):
            rosen = (100 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                     + (1 - x[:, :-1]) ** 2).sum(-1)
            quad = ((x - 0.3) ** 2 * scale).sum(-1)
            return w[:, 0] * rosen + (1 - w[:, 0]) * quad
        return f

    full = lbfgs_solve(mixed(w), x0, 15)
    evals = set()
    for i in range(N):
        alone = lbfgs_solve(mixed(w[i:i + 1]), x0[i:i + 1], 15)
        assert torch.equal(alone.x[0], full.x[i]), i
        assert torch.equal(alone.loss[0], full.loss[i]), i
        evals.add(alone.evals)
    # the rows' searches end at different times; the batch runs the longest
    assert len(evals) > 1 and full.evals >= max(evals)


def test_value_and_grad_gives_each_row_its_own_gradient():
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    v, g = value_and_grad(lambda x: (x ** 2).sum(-1) * torch.arange(1.0, 5.0), x)
    torch.testing.assert_close(v, (x ** 2).sum(-1) * torch.arange(1.0, 5.0))
    torch.testing.assert_close(g, 2 * x * torch.arange(1.0, 5.0)[:, None])
    assert not v.requires_grad and not g.requires_grad

"""A batched L-BFGS with a zoom line search: N independent problems of
dimension D solved at once, each row with its own memory, stepsize and
line-search state.

It is the port's counterpart of ``optax.lbfgs()`` (optax 0.2.6) as the JAX
package's ``features/flame_fit.py::_lbfgs_solve`` runs it under ``vmap``:

* ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``
  (optax/_src/transform.py:1573, two-loop recursion :1497): the first step
  scales the gradient by min(1, 1/|g|), later steps by the last secant pair's
  (dw . du) / (du . du);
* ``scale(-1)``;
* ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` (optax/_src/linesearch.py:1331, the zoom
  of Nocedal and Wright's Algorithms 3.5 and 3.6 at :576): sufficient
  decrease with slope_rtol 1e-4 or Hager-Zhang's approximate decrease
  (approx_dec_rtol 1e-6), curvature with curv_rtol 0.9, stepsize guess 1,
  interval growth 2, cubic then quadratic then bisection steps
  (``_cubicmin``, ``_quadmin``), a safe step with sufficient decrease kept
  for when the search fails, interval precision 1e-5, tolerance 0.

Under ``vmap``, the line search's ``while_loop`` runs until every lane is
done and leaves the lanes that finished as they were; here the rows that
finished are masked out of every update, so a row's result depends only on
its own problem. Every step evaluates the objective and its gradient once
at the current parameters (as ``_lbfgs_solve`` does), then once per line
search iteration for the whole batch.

The objective ``value_fn`` maps parameters [N, D] to per-row losses [N]; the
rows must be independent, so that the gradient of the losses' sum is each
row's own gradient.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0
TOL = 0.0


class LbfgsResult(NamedTuple):
    x: torch.Tensor        # [N, D] parameters after the last step
    loss: torch.Tensor     # [N] loss at the START of the last step
    evals: int             # objective-and-gradient evaluations of the batch


def value_and_grad(value_fn: Callable, x: torch.Tensor):
    """(per-row losses [N], gradients [N, D]) of ``value_fn`` at ``x``."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        value = value_fn(x)
        (grad,) = torch.autograd.grad(value.sum(), x)
    return value.detach(), grad


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


# ---------------------------------------------------------------------------
# L-BFGS direction
# ---------------------------------------------------------------------------

class _Memory:
    """Per-row secant pairs: dw, du [N, m, D], rho [N, m]."""

    def __init__(self, x: torch.Tensor, m: int):
        n, d = x.shape
        self.m = m
        self.dw = x.new_zeros((n, m, d))
        self.du = x.new_zeros((n, m, d))
        self.rho = x.new_zeros((n, m))
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.count = 0


def _lbfgs_direction(mem: _Memory, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``scale_by_lbfgs`` then ``scale(-1)``: the descent direction -P g,
    after storing the secant pair of the last step."""
    m, count = mem.m, mem.count
    memory_idx = count % m
    if count > 0:
        dw, du = x - mem.params, g - mem.updates
        vdot = _vdot(du, dw)
        weight = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        prev = (count - 1) % m
        mem.dw[:, prev], mem.du[:, prev], mem.rho[:, prev] = dw, du, weight
        den = _vdot(du, du)
        identity_scale = torch.where(den > 0.0, vdot / den, 1.0)[:, None]
    else:
        identity_scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(g, dim=-1),
                                         1.0)[:, None]

    # two-loop recursion over the slots from oldest to newest; slots never
    # written hold zeros and change nothing, so they are skipped
    order = [(memory_idx + i) % m for i in range(m)][max(0, m - count):]
    vec, alphas = g, {}
    for idx in reversed(order):
        alphas[idx] = mem.rho[:, idx] * _vdot(mem.dw[:, idx], vec)
        vec = vec + (-alphas[idx])[:, None] * mem.du[:, idx]
    vec = identity_scale * vec
    for idx in order:
        beta = mem.rho[:, idx] * _vdot(mem.du[:, idx], vec)
        vec = vec + (alphas[idx] - beta)[:, None] * mem.dw[:, idx]

    mem.params, mem.updates, mem.count = x, g, count + 1
    return -vec


# ---------------------------------------------------------------------------
# Zoom line search
# ---------------------------------------------------------------------------

def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none; the caller then ignores it)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * dc * dc)) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    decrease_error = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    # Hager-Zhang's approximate decrease, taken only near the minimiser
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta_values)
    decrease_error = torch.clamp_min(torch.minimum(approx, decrease_error), 0.0)
    return torch.where(torch.isnan(decrease_error), torch.inf, decrease_error)


def _curvature_error(slope_step, slope_init):
    curvature_error = torch.clamp_min(
        torch.abs(slope_step) - CURV_RTOL * torch.abs(slope_init), 0.0)
    return torch.where(torch.isnan(curvature_error), torch.inf, curvature_error)


def _zoom_linesearch(value_fn, x, d, value, grad):
    """Stepsizes [N] along ``d`` from ``x``, and the evaluations made.

    The state is optax's ``ZoomLinesearchState`` without the gradients and
    the errors: the caller takes only the stepsize and evaluates the next
    step's gradient itself."""
    slope = _vdot(d, grad)
    zero = torch.zeros_like(value)
    false = torch.zeros_like(value, dtype=torch.bool)
    s = dict(stepsize=zero, value=value, slope=slope,
             low=zero, value_low=value, slope_low=slope,
             high=zero, value_high=value, slope_high=slope,
             cubic_ref=zero, value_cubic_ref=value,
             safe_stepsize=zero, safe_value=value,
             interval_found=false, done=false, failed=false,
             count=torch.zeros_like(value, dtype=torch.int32))
    value_init, slope_init = value, slope
    evals = 0
    while True:
        active = ~(s["done"] | s["failed"])
        if not bool(active.any()):
            break
        count, found = s["count"], s["interval_found"]
        low, high = s["low"], s["high"]
        value_low, slope_low = s["value_low"], s["slope_low"]

        # the next trial: the search grows the stepsize (guess 1 first), the
        # zoom takes a cubic, else quadratic, else bisection step
        new_stepsize = torch.where(count == 0, 1.0, INCREASE_FACTOR * s["stepsize"])
        delta = torch.abs(high - low)
        left, right = torch.minimum(high, low), torch.maximum(high, low)
        middle_cubic = _cubicmin(low, value_low, slope_low, high, s["value_high"],
                                 s["cubic_ref"], s["value_cubic_ref"])
        use_cubic = ((middle_cubic > left + 0.2 * delta)
                     & (middle_cubic < right - 0.2 * delta))
        middle_quad = _quadmin(low, value_low, slope_low, high, s["value_high"])
        use_quad = (~use_cubic & (middle_quad > left + 0.1 * delta)
                    & (middle_quad < right - 0.1 * delta))
        middle = torch.where(use_cubic, middle_cubic, s["cubic_ref"])
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(~use_cubic & ~use_quad, (low + high) / 2.0, middle)
        trial = torch.where(found, middle, new_stepsize)

        v_t, g_t = value_and_grad(value_fn, x + trial[:, None] * d)
        evals += 1
        slope_t = _vdot(g_t, d)
        dec = _decrease_error(trial, v_t, slope_t, value_init, slope_init)
        curv = _curvature_error(slope_t, slope_init)
        error = torch.maximum(dec, curv)
        safe_decrease = dec <= TOL
        last = (count + 1) >= MAX_LINESEARCH_STEPS

        # search for an interval (Algorithm 3.5)
        high_to_new = (dec > 0.0) | ((v_t >= s["value"]) & (count > 0))
        low_to_new = (slope_t >= 0.0) & ~high_to_new
        srch = dict(
            low=torch.where(low_to_new, trial, s["stepsize"]),
            value_low=torch.where(low_to_new, v_t, s["value"]),
            slope_low=torch.where(low_to_new, slope_t, s["slope"]),
            high=torch.where(low_to_new, s["stepsize"], trial),
            value_high=torch.where(low_to_new, s["value"], v_t),
            slope_high=torch.where(low_to_new, s["slope"], slope_t),
            interval_found=high_to_new | low_to_new | (error <= TOL),
            done=error <= TOL)
        srch.update(cubic_ref=srch["low"], value_cubic_ref=srch["value_low"],
                    failed=last & ~srch["done"])

        # zoom into it (Algorithm 3.6)
        high_to_mid = (dec > 0.0) | (v_t >= value_low)
        high_to_low = ((slope_t * (high - low)) >= 0.0) & ~high_to_mid
        new_high = torch.where(high_to_mid, trial, high)
        new_value_high = torch.where(high_to_mid, v_t, s["value_high"])
        new_slope_high = torch.where(high_to_mid, slope_t, s["slope_high"])
        moved_high = high_to_mid | high_to_low
        zoom = dict(
            low=torch.where(high_to_mid, low, trial),
            value_low=torch.where(high_to_mid, value_low, v_t),
            slope_low=torch.where(high_to_mid, slope_low, slope_t),
            high=torch.where(high_to_low, low, new_high),
            value_high=torch.where(high_to_low, value_low, new_value_high),
            slope_high=torch.where(high_to_low, slope_low, new_slope_high),
            cubic_ref=torch.where(moved_high, high, low),
            value_cubic_ref=torch.where(moved_high, s["value_high"], value_low),
            interval_found=found, done=error <= TOL)
        # the safe step: sufficient decrease (and, zooming, a lower value)
        take_safe = safe_decrease & (~found | (v_t < s["safe_value"]))
        safe_step = torch.where(take_safe, trial, s["safe_stepsize"])
        zoom["failed"] = ((last | ((delta <= STEPSIZE_PRECISION) & (safe_step > 0.0)))
                          & ~zoom["done"])

        new = {k: torch.where(found, zoom[k], srch[k]) for k in zoom}
        # a failed search falls back to the safe step, or to no step where
        # the objective was not even finite
        fallback = new["failed"] & ((safe_step > 0.0) | torch.isinf(dec))
        new.update(stepsize=torch.where(fallback, safe_step, trial), value=v_t,
                   slope=slope_t, safe_stepsize=safe_step,
                   safe_value=torch.where(take_safe, v_t, s["safe_value"]),
                   count=count + 1)
        for k, v in new.items():
            s[k] = torch.where(active, v, s[k])
    return s["stepsize"], evals


def lbfgs_solve(value_fn: Callable, x0: torch.Tensor, n_steps: int) -> LbfgsResult:
    """``n_steps`` L-BFGS steps from ``x0`` [N, D] on the per-row objective
    ``value_fn`` ([N, D] -> [N]). Returns the parameters after the last
    step and, like the JAX package's ``_lbfgs_solve``, the loss at the START
    of the last step (the loss of ``x0`` when ``n_steps`` is 1)."""
    x = x0.detach()
    mem = _Memory(x, MEMORY_SIZE)
    loss, evals = None, 0
    for _ in range(n_steps):
        loss, grad = value_and_grad(value_fn, x)
        d = _lbfgs_direction(mem, x, grad)
        stepsize, n_ls = _zoom_linesearch(value_fn, x, d, loss, grad)
        x = x + stepsize[:, None] * d
        evals += 1 + n_ls
    return LbfgsResult(x, loss, evals)

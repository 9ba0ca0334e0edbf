"""Samplers for the hyperparameter search harness (the port's own copy of
``lets_face_it_tpu/train/samplers.py``, the same arithmetic, so that with
the same seed and history both packages suggest the same values).

The reference drives its search with Optuna's default TPE sampler
(hparams_tuning.py:112-209). Optuna is not a dependency, so this module
implements the same idea from scratch: a univariate Tree-structured Parzen
Estimator (Bergstra et al. 2011) over the ``trial.suggest_*`` space.

How it works: completed trials are split into the best ``gamma`` fraction
("good") and the rest ("bad"). For each parameter, candidates are drawn from
a Parzen (Gaussian-kernel) density fitted to the good observations, and the
candidate maximizing the density ratio l(x)/g(x) — likely under good, unlikely
under bad — is chosen. Categorical parameters use smoothed category-frequency
ratios. Until ``n_startup`` trials have completed, sampling is uniform random.
"""

from __future__ import annotations

import math
import random


class RandomSampler:
    """Independent uniform sampling (the round-1 behavior)."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def rng_for_trial(self, number: int) -> random.Random:
        return random.Random(self.seed + number)

    def observe(self, params: dict, value: float):  # pragma: no cover
        pass

    def suggest(self, rng: random.Random, name: str, kind: str, meta: dict):
        if kind == "categorical":
            return rng.choice(list(meta["choices"]))
        if kind == "int":
            return rng.randint(meta["low"], meta["high"])
        if kind == "loguniform":
            return math.exp(rng.uniform(math.log(meta["low"]),
                                        math.log(meta["high"])))
        return rng.uniform(meta["low"], meta["high"])


class TPESampler(RandomSampler):
    """Univariate TPE: model P(param | good) and P(param | bad) with Parzen
    windows and pick the candidate with the best good/bad density ratio."""

    def __init__(self, seed: int = 0, *, n_startup: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24):
        super().__init__(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.history: list[tuple[dict, float]] = []

    # -- observation ---------------------------------------------------------

    def observe(self, params: dict, value: float):
        """Record a completed trial (smaller value = better)."""
        if value is not None and math.isfinite(value):
            self.history.append((dict(params), float(value)))

    def _split(self, name: str):
        """(good_values, bad_values) among trials that set ``name``."""
        seen = [(p[name], v) for p, v in self.history if name in p]
        if not seen:
            return [], []
        seen.sort(key=lambda t: t[1])
        n_good = max(1, int(math.ceil(self.gamma * len(seen))))
        return ([x for x, _ in seen[:n_good]],
                [x for x, _ in seen[n_good:]])

    # -- sampling ------------------------------------------------------------

    def suggest(self, rng: random.Random, name: str, kind: str, meta: dict):
        if len(self.history) < self.n_startup:
            return super().suggest(rng, name, kind, meta)
        good, bad = self._split(name)
        if not good:
            return super().suggest(rng, name, kind, meta)
        if kind == "categorical":
            return self._suggest_categorical(rng, meta["choices"], good, bad)
        return self._suggest_numeric(rng, kind, meta, good, bad)

    def _suggest_categorical(self, rng, choices, good, bad):
        choices = list(choices)

        def smoothed(obs):
            counts = {c: 1.0 for c in choices}  # add-one smoothing
            for x in obs:
                if x in counts:
                    counts[x] += 1.0
            total = sum(counts.values())
            return {c: counts[c] / total for c in choices}

        p_good, p_bad = smoothed(good), smoothed(bad)
        # draw candidates from the good distribution, keep the best ratio
        population = choices
        weights = [p_good[c] for c in choices]
        cands = rng.choices(population, weights=weights, k=self.n_candidates)
        return max(cands, key=lambda c: p_good[c] / p_bad[c])

    def _suggest_numeric(self, rng, kind, meta, good, bad):
        low, high = meta["low"], meta["high"]
        log = kind == "loguniform"
        to_x = math.log if log else (lambda v: v)
        lo, hi = to_x(low), to_x(high)
        good_x = [min(max(to_x(v), lo), hi) for v in good]
        bad_x = [min(max(to_x(v), lo), hi) for v in bad]

        def parzen(obs):
            """(centers, sigmas) incl. a wide prior kernel over the range.

            Per-kernel bandwidth = distance to the farther sorted neighbour,
            clipped to [range/min(100, n+1), range] (the hyperopt/Bergstra
            heuristic) — narrow where observations cluster, wide where sparse.
            """
            span = hi - lo
            prior = (lo + hi) / 2.0
            pts = sorted([(v, False) for v in obs] + [(prior, True)])
            n = len(pts)
            centers, sigmas = [], []
            for i, (c, is_prior) in enumerate(pts):
                if is_prior:
                    s = span
                else:
                    left = c - pts[i - 1][0] if i > 0 else span
                    right = pts[i + 1][0] - c if i < n - 1 else span
                    s = max(left, right)
                    s = min(max(s, span / min(100.0, n + 1.0)), span)
                centers.append(c)
                sigmas.append(s)
            return centers, sigmas

        def logpdf(x, centers, sigmas):
            acc = 0.0
            for c, s in zip(centers, sigmas):
                acc += math.exp(-0.5 * ((x - c) / s) ** 2) / s
            return math.log(acc / len(centers) + 1e-300)

        gc, gs = parzen(good_x)
        bc, bs = parzen(bad_x)

        best_x, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            i = rng.randrange(len(gc))
            x = min(max(rng.gauss(gc[i], gs[i]), lo), hi)
            score = logpdf(x, gc, gs) - logpdf(x, bc, bs)
            if score > best_score:
                best_x, best_score = x, score
        value = math.exp(best_x) if log else best_x
        if kind == "int":
            value = min(max(int(round(value)), meta["low"]), meta["high"])
        return value


def make_sampler(spec, seed: int = 0):
    """'random' | 'tpe' | an existing sampler instance."""
    if isinstance(spec, (RandomSampler, TPESampler)):
        return spec
    if spec == "random":
        return RandomSampler(seed)
    if spec == "tpe":
        return TPESampler(seed)
    raise ValueError(f"unknown sampler {spec!r}")

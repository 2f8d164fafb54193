"""Hyperparameter search (the reference's Optuna sweeps,
``configs/hparams_search/*.yaml``, without the optuna dependency).

Copy of ``evi_rag_tpu/train/sweep.py`` on the port's config helpers and
numpy's ``default_rng(seed)``, so that the same spec, seed and history give
the same trial overrides as the JAX package.  A sweep spec maps dotted
config keys to search spaces::

    space:
      retriever.train.optimizer.learning_rate: {dist: loguniform, low: 1e-5, high: 1e-2}
      retriever.model.hidden_dim: {dist: choice, values: [256, 512, 1024]}
      retriever.train.loss.infonce_temperature: {dist: uniform, low: 0.3, high: 2.0}

Strategies: ``random`` (seeded), ``grid`` (cartesian over choice spaces),
and ``tpe`` -- a Tree-structured Parzen Estimator: after a random startup
phase, observed trials split into good/bad quantiles and new points are
drawn from the good-trial Parzen density, ranked by the density ratio
l(x)/g(x).  Runs are independent and failure-tolerant: a crashed trial
records its error and the sweep continues.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import traceback
from typing import Any, Callable

import numpy as np

from evi_rag_tpu_torch.utils.config import deep_merge, set_dotted
from evi_rag_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def sample_space(space: dict[str, dict], rng: np.random.Generator) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for key, spec in space.items():
        dist = spec.get("dist", "choice")
        if dist == "choice":
            out[key] = spec["values"][int(rng.integers(len(spec["values"])))]
        elif dist == "uniform":
            out[key] = float(rng.uniform(spec["low"], spec["high"]))
        elif dist == "loguniform":
            out[key] = float(np.exp(rng.uniform(np.log(spec["low"]), np.log(spec["high"]))))
        elif dist == "int_uniform":
            out[key] = int(rng.integers(spec["low"], spec["high"] + 1))
        else:
            raise ValueError(f"unknown dist {dist!r} for {key}")
    return out


def _parzen_logpdf(x: float, mus: np.ndarray, bw: float, low: float, high: float) -> float:
    """Mean of Gaussian kernels at ``mus`` plus one uniform prior kernel."""
    if mus.size == 0:
        return -np.log(high - low)
    z = (x - mus) / bw
    kern = np.exp(-0.5 * z * z) / (bw * np.sqrt(2 * np.pi))
    prior = 1.0 / (high - low)
    return float(np.log((kern.sum() + prior) / (mus.size + 1) + 1e-300))


def tpe_suggest(
    space: dict[str, dict],
    history: list[dict[str, Any]],
    rng: np.random.Generator,
    *,
    mode: str = "max",
    gamma: float = 0.25,
    n_candidates: int = 24,
    n_startup: int = 5,
) -> dict[str, Any]:
    """One TPE suggestion given completed trials (``{'overrides','score'}``)."""
    ok = [t for t in history if t.get("status") == "ok"]
    if len(ok) < n_startup:
        return sample_space(space, rng)
    sign = 1.0 if mode == "max" else -1.0
    ranked = sorted(ok, key=lambda t: -sign * t["score"])
    n_good = max(1, int(np.ceil(gamma * len(ranked))))
    good = [t["overrides"] for t in ranked[:n_good]]
    bad = [t["overrides"] for t in ranked[n_good:]]

    def numeric(spec, values):
        lo, hi = float(spec["low"]), float(spec["high"])
        logspace = spec.get("dist") == "loguniform"
        if logspace:
            lo, hi = np.log(lo), np.log(hi)
            values = np.log(np.asarray(values, float)) if len(values) else np.asarray([])
        else:
            values = np.asarray(values, float)
        bw = max((hi - lo) / np.sqrt(len(values) + 1), 1e-12)
        return lo, hi, bw, values, logspace

    best_cand, best_ei = None, -np.inf
    for _ in range(n_candidates):
        cand: dict[str, Any] = {}
        ei = 0.0
        for key, spec in space.items():
            dist = spec.get("dist", "choice")
            gv = [o[key] for o in good if key in o]
            bv = [o[key] for o in bad if key in o]
            if dist == "choice":
                values = list(spec["values"])
                counts_g = np.asarray([1.0 + sum(v == c for v in gv) for c in values])
                counts_b = np.asarray([1.0 + sum(v == c for v in bv) for c in values])
                pg = counts_g / counts_g.sum()
                pb = counts_b / counts_b.sum()
                idx = int(rng.choice(len(values), p=pg))
                cand[key] = values[idx]
                ei += float(np.log(pg[idx]) - np.log(pb[idx]))
            else:
                lo, hi, bw, mus_g, logspace = numeric(spec, gv)
                _, _, bw_b, mus_b, _ = numeric(spec, bv)
                if mus_g.size and rng.random() > 1.0 / (mus_g.size + 1):
                    x = float(rng.normal(mus_g[int(rng.integers(mus_g.size))], bw))
                else:
                    x = float(rng.uniform(lo, hi))
                x = float(np.clip(x, lo, hi))
                ei += _parzen_logpdf(x, mus_g, bw, lo, hi) - _parzen_logpdf(
                    x, mus_b, bw_b, lo, hi
                )
                x_out = float(np.exp(x)) if logspace else x
                if dist == "int_uniform":
                    x_out = int(round(x_out))
                cand[key] = x_out
        if ei > best_ei:
            best_cand, best_ei = cand, ei
    assert best_cand is not None
    return best_cand


def grid_points(space: dict[str, dict]) -> list[dict[str, Any]]:
    keys = sorted(space)
    values = []
    for k in keys:
        spec = space[k]
        if spec.get("dist", "choice") != "choice":
            raise ValueError(f"grid search requires choice spaces; {k} is {spec.get('dist')}")
        values.append(spec["values"])
    return [dict(zip(keys, combo)) for combo in itertools.product(*values)]


def run_sweep(
    base_cfg: dict,
    space: dict[str, dict],
    objective: Callable[[dict], dict[str, float]],
    *,
    monitor: str,
    mode: str = "max",
    strategy: str = "random",
    num_trials: int = 10,
    seed: int = 0,
    out_path: str | pathlib.Path | None = None,
) -> dict[str, Any]:
    """Run trials; returns {best, trials}.  ``objective(cfg) -> metrics``."""
    rng = np.random.default_rng(seed)
    if strategy == "grid":
        points: list[dict[str, Any]] | None = grid_points(space)
        num_trials = len(points)
    elif strategy == "random":
        points = [sample_space(space, rng) for _ in range(num_trials)]
    elif strategy == "tpe":
        points = None  # sequential: each point depends on trial history
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    sign = 1.0 if mode == "max" else -1.0
    trials: list[dict[str, Any]] = []
    best: dict[str, Any] | None = None
    for i in range(num_trials):
        overrides = (
            tpe_suggest(space, trials, rng, mode=mode) if points is None else points[i]
        )
        cfg = deep_merge(base_cfg, {})
        for key, value in overrides.items():
            set_dotted(cfg, key, value)
        record: dict[str, Any] = {"trial": i, "overrides": overrides}
        try:
            metrics = objective(cfg)
            score = float(metrics.get(monitor, float("-inf") * sign))
            record.update(status="ok", score=score, metrics=metrics)
            if best is None or sign * score > sign * best["score"]:
                best = record
        except Exception as exc:  # failure-tolerant sweep
            record.update(status="error", error=str(exc), traceback=traceback.format_exc())
            log.warning("trial %d failed: %s", i, exc)
        trials.append(record)
        if out_path is not None:
            pathlib.Path(out_path).write_text(
                json.dumps({"best": best, "trials": trials}, indent=2, default=str)
            )
    return {"best": best, "trials": trials}

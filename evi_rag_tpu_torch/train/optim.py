"""Config-driven optimizers: AdamW / SGD / Muon with glob parameter groups
and learning-rate schedules, with optax's update rules.

Counterpart of ``evi_rag_tpu/train/optim.py``.  The rules are written as
plain tensor functions over a flat ``{flax path: tensor}`` dict, following
optax rather than ``torch.optim``'s conventions:

* the schedule is evaluated at the update count *before* the increment, so
  the first step uses ``schedule(0)`` (0 under a warmup);
* the global clip (``optax.clip_by_global_norm``) scales by
  ``max_norm / norm`` only when ``norm >= max_norm``, with no epsilon;
* AdamW: ``eps = 1e-8``, ``eps_root = 0``, bias corrections in f32, the
  decay added to every leaf of the group, then ``-lr``;
* Muon: trace, nesterov, Newton-Schulz in bf16, a scale of
  ``sqrt(max(1, rows / cols))``, weight decay, then ``-lr``; leaves that are
  not 2-D fall through with (nesterov) momentum;
* SGD: optax's ``trace`` momentum (no dampening), no weight decay.

Parameter groups are fnmatch patterns over flax paths
(``params/state_net_*/kernel``); the first group that matches a leaf takes
it, the rest go to the default group.  The state is a flat dict of tensors
(``count`` on the host, ``mu/<path>``, ``nu/<path>``, ``trace/<path>`` beside
their parameters) that the checkpoint stores under ``opt_state/``.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
from typing import Callable

import torch

# Quintic Newton-Schulz coefficients (the standard Muon setting).
_NS_COEFFS = (3.4445, -4.7750, 2.0315)
_ADAM_EPS = 1e-8


def newton_schulz_orthogonalize(g: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Approximate the orthogonal polar factor of a 2-D matrix by iterating
    ``X <- a X + (b XX^T + c (XX^T)^2) X`` in bf16; wide matrices are
    handled by transposing."""
    if g.ndim != 2:
        raise ValueError(f"newton_schulz expects 2D, got {tuple(g.shape)}")
    a, b, c = _NS_COEFFS
    transpose = g.shape[0] > g.shape[1]
    x = g.to(torch.bfloat16)
    if transpose:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + eps)
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    if transpose:
        x = x.T
    return x.to(g.dtype)


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    """A glob-pattern parameter group."""

    patterns: tuple[str, ...]
    optimizer: str = "adamw"  # adamw | muon | sgd
    lr_scale: float = 1.0
    weight_decay: float | None = None
    momentum: float = 0.95


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"                # default optimizer for ungrouped params
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    momentum: float = 0.95
    grad_clip_norm: float | None = 1.0
    groups: tuple[ParamGroup, ...] = ()
    # schedule: constant | cosine | cosine_restarts
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 10_000
    min_lr_ratio: float = 0.0
    restart_period: int = 1_000


# ------------------------------------------------------------------ schedules

def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule`` (no transition: constant ``init_value``)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` with exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps=}.")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def join_schedules(schedules: list, boundaries: list[int]) -> Callable[[int], float]:
    """``optax.join_schedules``: schedule i+1 runs from boundary i on, at
    ``count - boundary``."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = fn(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` with exponent 1."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps],
    )


def make_schedule(cfg: OptimizerConfig, lr: float) -> Callable[[int], float]:
    if cfg.schedule == "constant":
        if cfg.warmup_steps:
            return linear_schedule(0.0, lr, cfg.warmup_steps)
        return lambda count: lr
    if cfg.schedule == "cosine":
        return warmup_cosine_decay_schedule(0.0, lr, cfg.warmup_steps,
                                            max(cfg.total_steps, cfg.warmup_steps + 1), lr * cfg.min_lr_ratio)
    if cfg.schedule == "cosine_restarts":
        period = max(cfg.restart_period, 1)
        n = max(1, -(-cfg.total_steps // period))
        one = lambda: warmup_cosine_decay_schedule(  # noqa: E731
            0.0, lr, min(cfg.warmup_steps, period // 2), period, lr * cfg.min_lr_ratio)
        return join_schedules([one() for _ in range(n)], [period * i for i in range(1, n)])
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


# ---------------------------------------------------------------- optimizer

def label_params(cfg: OptimizerConfig, paths) -> dict[str, str]:
    """``{flax path: group label}`` (``group<i>`` or ``default``)."""
    out = {}
    for path in paths:
        out[path] = next((f"group{i}" for i, g in enumerate(cfg.groups)
                          if any(fnmatch.fnmatch(path, pat) for pat in g.patterns)), "default")
    return out


@dataclasses.dataclass(frozen=True)
class _Rule:
    name: str
    schedule: Callable[[int], float]
    weight_decay: float
    momentum: float


def _rule(name: str, cfg: OptimizerConfig, lr_scale: float, wd: float, mom: float) -> _Rule:
    if name not in ("adamw", "muon", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    return _Rule(name, make_schedule(cfg, cfg.learning_rate * lr_scale), wd, mom)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


class Optimizer:
    """The optax chain ``clip_by_global_norm`` -> per-group rule, over a
    flat ``{flax path: tensor}`` parameter dict.  ``update`` returns the
    updates (to be added to the parameters) and the new state, as optax's
    ``tx.update`` does."""

    def __init__(self, cfg: OptimizerConfig, paths):
        self.cfg = cfg
        self.labels = label_params(cfg, paths)
        rules = {"default": _rule(cfg.name, cfg, 1.0, cfg.weight_decay, cfg.momentum)}
        for i, g in enumerate(cfg.groups):
            wd = cfg.weight_decay if g.weight_decay is None else g.weight_decay
            rules[f"group{i}"] = _rule(g.optimizer, cfg, g.lr_scale, wd, g.momentum)
        self.rules = {path: rules[label] for path, label in self.labels.items()}

    def init(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        # The count stays on the host: the schedule reads it every step.
        state = {"count": torch.zeros((), dtype=torch.int32)}
        for path, p in params.items():
            kinds = ("mu", "nu") if self.rules[path].name == "adamw" else ("trace",)
            for kind in kinds:
                state[f"{kind}/{path}"] = torch.zeros_like(p)
        return state

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict[str, torch.Tensor],
               params: dict[str, torch.Tensor]) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        cfg = self.cfg
        if cfg.grad_clip_norm:
            norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads.values()))
            max_norm = float(cfg.grad_clip_norm)
            grads = {k: torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)
                     for k, g in grads.items()}
        count = int(state["count"])
        new_state = {"count": state["count"] + 1}
        updates = {}
        for path, g in grads.items():
            rule, p = self.rules[path], params[path]
            if rule.name == "adamw":
                b1, b2 = cfg.b1, cfg.b2
                mu = (1 - b1) * g + b1 * state[f"mu/{path}"]
                nu = (1 - b2) * (g * g) + b2 * state[f"nu/{path}"]
                # optax: decay ** count in f32, count after the increment.
                bc1 = 1 - _f32(b1, g) ** (count + 1)
                bc2 = 1 - _f32(b2, g) ** (count + 1)
                u = (mu / bc1) / (torch.sqrt(nu / bc2 + 0.0) + _ADAM_EPS)
                if rule.weight_decay:
                    u = u + rule.weight_decay * p
                new_state[f"mu/{path}"], new_state[f"nu/{path}"] = mu, nu
            elif rule.name == "muon":
                trace = g + rule.momentum * state[f"trace/{path}"]
                eff = g + rule.momentum * trace
                if eff.ndim == 2:
                    eff = newton_schulz_orthogonalize(eff) * math.sqrt(max(1.0, eff.shape[0] / eff.shape[1]))
                u = eff + rule.weight_decay * p if rule.weight_decay else eff
                new_state[f"trace/{path}"] = trace
            else:  # sgd
                trace = g + rule.momentum * state[f"trace/{path}"]
                u = trace
                new_state[f"trace/{path}"] = trace
            updates[path] = _f32(-rule.schedule(count), u).to(u.dtype) * u
        return updates, new_state


def setup_optimizer(cfg: OptimizerConfig, paths) -> Optimizer:
    """Build a (possibly multi-group) optimizer for the parameters at
    ``paths`` (flax paths)."""
    return Optimizer(cfg, list(paths))

"""Port vs JAX (optax): optimizers, schedules and parameter groups.

The same parameters and the same gradients (numpy, from a seed) go through
``evi_rag_tpu.train.optim.setup_optimizer`` and the port's ``Optimizer`` for
3 steps.  AdamW (with decay and an active global clip) and SGD agree at f32
tolerance (rtol 1e-5 / atol 1e-7 on the parameters).  Muon's Newton-Schulz
runs in bf16, and its quintic step amplifies a one-ulp rounding difference
(XLA and torch round bf16 matmuls and elementwise chains at different
points) by about 3x per iteration: on the same input the two bf16 results
differ by 5-7% (relative Frobenius), whichever rounding points the port
takes.  So Muon leaves are held by the relative Frobenius error of the
3-step parameter change (10%), and Newton-Schulz also by its alignment with
the exact polar factor (the JAX package's own test); the adamw leaves of the
Muon run stay at f32 tolerance.  Schedules agree with optax within 1e-7 at
every step; group labels equal ``_label_params``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.train import optim as jopt
from evi_rag_tpu_torch.train import optim as topt

SHAPES = {"params/q_gate/kernel": (12, 8), "params/q_gate/bias": (8,),
          "params/state_net_0/kernel": (9, 16), "params/state_norm/scale": (16,),
          "params/entity_proj/proj/kernel": (8, 8)}
MUON_PATTERNS = ("params/state_net_*/kernel", "params/*_proj/*/kernel", "params/q_*/kernel")


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: np.asarray(v)})
    return out


def _run_both(jcfg, steps=3, grad_scale=1.0):
    rng = np.random.default_rng(0)
    params = {p: rng.normal(size=s).astype(np.float32) for p, s in SHAPES.items()}
    grads = [{p: (grad_scale * rng.normal(size=s)).astype(np.float32) for p, s in SHAPES.items()}
             for _ in range(steps)]
    jparams = jax.tree.map(jnp.asarray, _nest(params))
    tx = jopt.setup_optimizer(jcfg, jparams)
    jstate = tx.init(jparams)
    tcfg = topt.OptimizerConfig(**{**dataclasses.asdict(jcfg), "groups": tuple(
        topt.ParamGroup(**dataclasses.asdict(g)) for g in jcfg.groups)})
    tparams = {p: torch.from_numpy(v.copy()) for p, v in params.items()}
    opt = topt.setup_optimizer(tcfg, tparams)
    tstate = opt.init(tparams)
    for g in grads:
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, _nest(g)), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        tupd, tstate = opt.update({p: torch.from_numpy(v) for p, v in g.items()}, tstate, tparams)
        tparams = {p: tparams[p] + tupd[p] for p in tparams}
    return _flat(jparams), {p: v.numpy() for p, v in tparams.items()}, tstate


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(weight_decay=0.01, grad_clip_norm=1.0)),
    ("adamw", dict(grad_clip_norm=None, schedule="cosine", warmup_steps=2, total_steps=10)),
    ("sgd", dict(momentum=0.9, grad_clip_norm=1.0)),
])
def test_adamw_and_sgd_match_optax(name, kw):
    cfg = jopt.OptimizerConfig(name=name, learning_rate=1e-2, **kw)
    want, got, state = _run_both(cfg, grad_scale=3.0)  # the clip is active
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, atol=1e-7, err_msg=p)
    assert int(state["count"]) == 3


def test_muon_groups_match_optax_at_bf16_tolerance():
    lr = 1e-2
    cfg = jopt.OptimizerConfig(name="adamw", learning_rate=lr, weight_decay=0.01, schedule="cosine",
                               total_steps=20, groups=(jopt.ParamGroup(patterns=MUON_PATTERNS, optimizer="muon"),))
    want, got, state = _run_both(cfg)
    start = _run_both(cfg, steps=0)[0]
    for p in want:
        if p.endswith("kernel"):  # muon
            dw, dt = want[p] - start[p], got[p] - start[p]
            assert np.linalg.norm(dt - dw) <= 0.10 * np.linalg.norm(dw), p
        else:
            np.testing.assert_allclose(got[p], want[p], rtol=1e-5, atol=1e-7, err_msg=p)
    assert "trace/params/q_gate/kernel" in state and "mu/params/q_gate/bias" in state


@pytest.mark.parametrize("shape", [(16, 16), (32, 8), (8, 32)])
def test_newton_schulz_matches_jax(shape):
    g = np.random.default_rng(int(np.prod(shape))).normal(size=shape).astype(np.float32)
    want = np.asarray(jopt.newton_schulz_orthogonalize(jnp.asarray(g)))
    got = topt.newton_schulz_orthogonalize(torch.from_numpy(g)).numpy()
    assert np.linalg.norm(got - want) <= 0.10 * np.linalg.norm(want)  # see the module docstring
    u, _, vt = np.linalg.svd(g, full_matrices=False)
    polar = u @ vt
    assert float((got * polar).sum() / (np.linalg.norm(got) * np.linalg.norm(polar))) > 0.97


@pytest.mark.parametrize("kw", [
    dict(schedule="constant"),
    dict(schedule="constant", warmup_steps=5),
    dict(schedule="cosine", total_steps=30),
    dict(schedule="cosine", warmup_steps=7, total_steps=30, min_lr_ratio=0.1),
    dict(schedule="cosine_restarts", warmup_steps=4, total_steps=40, restart_period=12),
])
def test_schedules_match_optax(kw):
    cfg = jopt.OptimizerConfig(learning_rate=3e-4, **kw)
    jsched = jopt._make_schedule(cfg, 3e-4)
    tsched = topt.make_schedule(topt.OptimizerConfig(learning_rate=3e-4, **kw), 3e-4)
    for step in range(45):
        want = float(jsched(jnp.asarray(step, jnp.int32))) if callable(jsched) else float(jsched)
        assert abs(tsched(step) - want) <= 1e-7, (step, tsched(step), want)


def test_group_labels_match_label_params():
    cfg = jopt.OptimizerConfig(groups=(jopt.ParamGroup(patterns=MUON_PATTERNS, optimizer="muon"),
                                       jopt.ParamGroup(patterns=("params/*/bias",), optimizer="sgd")))
    tree = _nest({p: np.zeros(s, np.float32) for p, s in SHAPES.items()})
    want = _flat(jax.tree.map(lambda x: x, jopt._label_params(cfg, tree)))
    tcfg = topt.OptimizerConfig(groups=tuple(topt.ParamGroup(**dataclasses.asdict(g)) for g in cfg.groups))
    assert topt.label_params(tcfg, SHAPES) == {p: str(v) for p, v in want.items()}

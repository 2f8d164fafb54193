"""The quality gate for the port: ``tests/test_quality_thresholds.py``'s
task, trained by the port from its own init.

The same compact synthetic run (64 train / 16 test samples, data seeds
0 / 100, emb 128, 3-hop paths with within-layer distractors, 16 epochs of
InfoNCE + BCE, AdamW at 3e-3, monitor ``bridge/separation``) must clear the
JAX gate's floors on edge recall@10, bridge separation and the probability
separation gap, and the same metric plumbing fed by a broken scorer (logits
replaced by seeded noise) must land below them.  Nothing is carried over
from JAX: the parameters come from the port's ``torch.Generator`` init
(flax's moments, not flax's draws), so this shows that the port, trained on
its own, reaches the quality the reference's gate asks for.

``chip_smoke.py`` (phase 12b) runs the same gate on the card through
``quality_gate``.
"""

from __future__ import annotations

import dataclasses
from unittest import mock

import pytest
import torch

from evi_rag_tpu_torch.scripts.quality_gate import (
    MIN_BRIDGE_SEPARATION,
    MIN_RECALL_AT_10,
    MIN_SEPARATION_GAP,
    quality_gate,
)
from evi_rag_tpu_torch.train.retriever_trainer import evaluate, make_eval_step


def test_floors_are_the_jax_gates():
    import test_quality_thresholds as jgate

    assert (MIN_RECALL_AT_10, MIN_BRIDGE_SEPARATION, MIN_SEPARATION_GAP) == (
        jgate.MIN_RECALL_AT_10, jgate.MIN_BRIDGE_SEPARATION, jgate.MIN_SEPARATION_GAP)


@pytest.fixture(scope="module")
def trained():
    return quality_gate(device="cpu")


def test_bridge_positives_structurally_present(trained):
    """Every graph of the layered 3-hop task carries a positive edge that
    touches neither a topic nor an answer node."""
    metrics, _ = trained
    assert metrics["bridge/pos_graph_frac"] == 1.0, metrics


def test_trained_retriever_clears_quality_floors(trained):
    metrics, _ = trained
    assert metrics["edge/recall@10"] >= MIN_RECALL_AT_10, metrics
    assert metrics["bridge/separation"] >= MIN_BRIDGE_SEPARATION, metrics
    assert metrics["features/separation_gap"] >= MIN_SEPARATION_GAP, metrics


def test_broken_scorer_fails_quality_floors(trained):
    """Negative control: the same metric plumbing fed by a broken scorer
    (logits replaced by seeded noise) lands below the floors."""
    metrics, (model, cfg, best_params, test_batches) = trained

    forward = model.forward

    def noisy(batch, **kw):
        out = forward(batch, **kw)
        gen = torch.Generator(device=out.logits.device).manual_seed(0)
        noise = torch.randn(out.logits.shape, generator=gen, device=out.logits.device)
        return dataclasses.replace(out, logits=noise)

    with mock.patch.object(model, "forward", noisy):
        broken = evaluate(best_params, make_eval_step(model, cfg), test_batches())
    assert broken["bridge/separation"] < MIN_BRIDGE_SEPARATION, broken
    assert broken["features/separation_gap"] < MIN_SEPARATION_GAP, broken
    assert metrics["edge/recall@10"] > broken["edge/recall@10"] + 0.1, (metrics, broken)

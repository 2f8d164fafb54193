"""The quality gate: a compact synthetic training run that must clear fixed
floors (the port's counterpart of ``tests/test_quality_thresholds.py``).

The task plants fixed 3-hop paths with within-layer distractors
(``layered_distractors=True``), so the planted path's middle edge is a
bridge positive in every graph.  The retriever trains from the port's own
init (64 train / 16 test samples, emb 128, 16 epochs of InfoNCE + BCE, AdamW
at 3e-3, monitor ``bridge/separation``) and must reach the floors below on
the held-out split; the JAX gate measured recall@10 0.92 / 0.71, bridge
separation 0.376 / 0.381 and separation gap 0.416 / 0.421 at data seeds
{0, 7} / {100, 107}, and a broken scorer 0.54 / 0.38, 0.077 / 0.104, 0.038.

Usage: python -m evi_rag_tpu_torch.scripts.quality_gate [--device cpu]
(the card unless ``--device cpu``); prints the metrics against the floors
as one JSON line and exits 1 if a floor fails.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

import torch

MIN_RECALL_AT_10 = 0.60
MIN_BRIDGE_SEPARATION = 0.15
MIN_SEPARATION_GAP = 0.20
FLOORS = {"edge/recall@10": MIN_RECALL_AT_10, "bridge/separation": MIN_BRIDGE_SEPARATION,
          "features/separation_gap": MIN_SEPARATION_GAP}
SAMPLES = 64
EMB = 128
EPOCHS = 16
KS = (1, 10, 25)


def quality_gate(device: str | torch.device | None = None) -> tuple[dict[str, float], tuple]:
    """Train the gate's retriever on ``device`` and evaluate its best
    parameters on the held-out split.  Returns (metrics, (model, cfg,
    best_params, test_batches))."""
    from evi_rag_tpu_torch.data.feeder import collate_retriever, fixed_bucket_for, iter_stacked_batches
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.models.losses import RetrieverLossConfig
    from evi_rag_tpu_torch.models.retriever import Retriever
    from evi_rag_tpu_torch.train.optim import OptimizerConfig
    from evi_rag_tpu_torch.train.retriever_trainer import RetrieverTrainConfig, evaluate, fit, make_eval_step

    # avg_extra_edges compensates for the within-layer keep rule, so that a
    # random scorer does not clear recall@10.
    kw = dict(emb_dim=EMB, max_nodes=32, distractor_relation_overlap=0.15, path_len_range=(3, 3),
              layered_distractors=True, avg_extra_edges=5.0)
    train_ds = make_synthetic_dataset(num_samples=SAMPLES, seed=0, **kw)
    test_ds = make_synthetic_dataset(num_samples=16, seed=100, **kw)
    model = Retriever(emb_dim=EMB, hidden_dim=EMB, dropout_p=0.0)
    cfg = RetrieverTrainConfig(
        # bridge/separation is measured in probability space: the BCE term
        # calibrates the sigmoid, which InfoNCE alone leaves free.
        loss=RetrieverLossConfig(bce_weight=1.0),
        optimizer=OptimizerConfig(name="adamw", learning_rate=3e-3, grad_clip_norm=1.0),
        max_epochs=EPOCHS,
        # recall@10 saturates within a few epochs and would freeze the best
        # parameters before the BCE head calibrates.
        monitor="bridge/separation",
        k_values=KS,
        patience=EPOCHS,
    )
    bucket = fixed_bucket_for(train_ds.samples + test_ds.samples, 8)

    def tables(ds) -> dict[str, Any]:
        return dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb)

    def train_batches(epoch):
        return iter_stacked_batches(train_ds.samples, num_shards=1, per_shard_batch=8, bucket=bucket,
                                    seed=epoch, **tables(train_ds))

    def test_batches():
        for i in range(0, len(test_ds.samples), 8):
            yield collate_retriever(test_ds.samples[i : i + 8], bucket=bucket, **tables(test_ds))

    best_params, _ = fit(model, cfg, train_batches, test_batches, seed=0, device=device)
    metrics = evaluate(best_params, make_eval_step(model, cfg), test_batches())
    return metrics, (model, cfg, best_params, test_batches)


def failed_floors(metrics: dict[str, float]) -> list[str]:
    """The gate's metrics below their floors (empty when the gate holds)."""
    return [k for k, floor in FLOORS.items() if not metrics[k] >= floor]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    metrics, _ = quality_gate(args.device)
    failed = failed_floors(metrics)
    print(json.dumps({"metrics": {k: metrics[k] for k in (*FLOORS, "bridge/pos_graph_frac")},
                      "floors": FLOORS, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Self-measured quality baseline of the port: the full pipeline on synthetic
KGQA (the counterpart of ``scripts/benchmark_quality.py``).

Trains the retriever, materialises the agent graphs of the held-out split,
trains the GFlowNet on them and reports the metric grid: edge recall@k and
answer reachability@k of the retriever, oracle answer hit / recall@k over
the agent graphs, and the GFlowNet's best-of-k answer_hit.  The stages,
settings and table layout are the JAX script's; ``--seed`` sets the
retriever's and the GFlowNet's init and draws (the data stays seeds
0 / 100), and the run is on the card unless ``--device cpu``.

Usage::

    python -m evi_rag_tpu_torch.scripts.benchmark_quality [--samples 128] [--emb 64] \\
        [--epochs 10] [--seed 0] [--device cpu] [--out artifacts/quality/RESULTS_port.md]

Writes the Markdown tables to ``--out`` and prints them, then the metric
grid as one JSON line (``grid``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import Any

import numpy as np
import torch

KS = (1, 5, 10, 25, 50, 100)
ROLLOUT_PREFIXES = (1, 4, 10)
DEFAULT_OUT = "artifacts/quality/RESULTS_port.md"  # artifacts/ is git-ignored


def run(*, samples: int = 128, emb: int = 64, epochs: int = 10, seed: int = 0,
        device: str | torch.device | None = None) -> dict[str, Any]:
    """The four stages on ``device``: returns the retriever's, the oracle's
    and the GFlowNet's metrics, the test split's size, the wall time, and
    the retriever's best parameters (``retriever_params``, a checkpoint's
    tree) with its ``parity_meta``."""
    from evi_rag_tpu_torch.data.feeder import (
        collate_agent,
        collate_retriever,
        fixed_agent_bucket,
        fixed_bucket_for,
        iter_stacked_batches,
    )
    from evi_rag_tpu_torch.data.g_agent import AgentSettings, build_agent_sample
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.eval.oracle import aggregate_oracle_metrics, oracle_metrics_for_sample
    from evi_rag_tpu_torch.models.losses import RetrieverLossConfig
    from evi_rag_tpu_torch.models.retriever import Retriever
    from evi_rag_tpu_torch.train.checkpoint import export_retriever_features
    from evi_rag_tpu_torch.train.gflownet_trainer import GFlowNetConfig, fit_gflownet
    from evi_rag_tpu_torch.train.optim import OptimizerConfig
    from evi_rag_tpu_torch.train.retriever_trainer import RetrieverTrainConfig, evaluate, fit, make_eval_step
    from evi_rag_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    t_start = time.time()
    # distractor_relation_overlap < 1: relation-distinctive answers, so that
    # margins and separation measure learning.
    kw = dict(emb_dim=emb, max_nodes=32, distractor_relation_overlap=0.15)
    train_ds = make_synthetic_dataset(num_samples=samples, seed=0, **kw)
    test_ds = make_synthetic_dataset(num_samples=max(samples // 4, 16), seed=100, **kw)
    model = Retriever(emb_dim=emb, hidden_dim=emb, dropout_p=0.0)
    cfg = RetrieverTrainConfig(
        loss=RetrieverLossConfig(),
        optimizer=OptimizerConfig(name="adamw", learning_rate=3e-3, grad_clip_norm=1.0),
        max_epochs=epochs,
        monitor="edge/recall@10",
        k_values=KS,
        patience=epochs,
    )
    bucket = fixed_bucket_for(train_ds.samples + test_ds.samples, 8)
    kw_tr = dict(entity_emb=train_ds.entity_emb, relation_emb=train_ds.relation_emb,
                 question_emb=train_ds.question_emb)
    kw_te = dict(entity_emb=test_ds.entity_emb, relation_emb=test_ds.relation_emb,
                 question_emb=test_ds.question_emb)

    def train_batches(epoch):
        return iter_stacked_batches(train_ds.samples, num_shards=1, per_shard_batch=8, bucket=bucket,
                                    seed=epoch, **kw_tr)

    def test_batches():
        for i in range(0, len(test_ds.samples), 8):
            yield collate_retriever(test_ds.samples[i : i + 8], bucket=bucket, **kw_te)

    best_params, _ = fit(model, cfg, train_batches, test_batches, seed=seed, device=dev)
    eval_step = make_eval_step(model, cfg)
    retr = evaluate(best_params, eval_step, test_batches())

    # Agent graphs and the oracle on the held-out split.
    settings = AgentSettings(edge_top_k=100, max_hops=3, score_mode="node_softmax", allow_empty_answer=True)
    agent_samples, oracle_inputs = [], []
    i = 0
    for batch in test_batches():
        scores = eval_step(best_params, batch)["logits"].float().cpu().numpy()
        eb = batch.graph.edge_batch.numpy()
        emask = batch.graph.edge_mask.numpy()
        for g, s in enumerate(test_ds.samples[i : i + 8]):
            sel = np.nonzero((eb == g) & emask)[0]
            ent_ids = np.arange(1000, 1000 + s.num_nodes)
            a = build_agent_sample(
                sample_id=s.sample_id, question_id=s.question_id,
                heads=s.edge_index[0], tails=s.edge_index[1], relations=s.edge_relations,
                labels=s.edge_labels.astype(np.float32), scores=scores[sel],
                node_entity_ids=ent_ids, node_embedding_ids=s.node_embedding_ids,
                start_entity_ids=ent_ids[s.topic_locals], answer_entity_ids=ent_ids[s.answer_locals],
                settings=settings,
            )
            if a is not None:
                agent_samples.append(a)
                order = np.argsort(-a.edge_scores, kind="stable")
                oracle_inputs.append({
                    "head_entity_ids": a.node_entity_ids[a.edge_head_locals[order]],
                    "tail_entity_ids": a.node_entity_ids[a.edge_tail_locals[order]],
                    "answer_entity_ids": a.answer_entity_ids,
                })
        i += 8
    oracle = aggregate_oracle_metrics([oracle_metrics_for_sample(k_values=KS, **x) for x in oracle_inputs])

    # The GFlowNet on the agent graphs of the answer-reachable questions.
    bundle = export_retriever_features(best_params["params"], model.parity_meta())
    reachable = [a for a in agent_samples if a.is_answer_reachable]
    abucket = fixed_agent_bucket(reachable, 8)
    gcfg = GFlowNetConfig(
        hidden_dim=emb, max_steps=3, stop_on_answer=True, num_train_rollouts=4,
        bc_weight=0.5, total_steps=500, eval_rollout_prefixes=ROLLOUT_PREFIXES,
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3), max_epochs=5,
        dropout=0.0,
    )

    def agent_batches(epoch=0):
        order = np.arange(len(reachable))
        np.random.default_rng(epoch).shuffle(order)
        for j in range(0, len(order), 8):
            yield collate_agent([reachable[x] for x in order[j : j + 8]], bucket=abucket, **kw_te)

    _, gfn_info = fit_gflownet(gcfg, bundle, agent_batches, lambda: agent_batches(999), seed=seed, device=dev)
    gfn = gfn_info["history"][-1]["val"] if gfn_info["history"] else {}
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return dict(retriever=retr, oracle=oracle, gflownet=gfn, test_samples=len(test_ds.samples),
                agent_samples=len(agent_samples), reachable=len(reachable), device=str(dev), device_kind=kind,
                elapsed_s=time.time() - t_start, retriever_params=best_params, parity_meta=model.parity_meta())


def metric_grid(result: dict[str, Any]) -> dict[str, float]:
    """The tables' values as one flat dict: ``edge/recall@k``,
    ``answer/reachability@k``, ``oracle/answer_hit@k``,
    ``oracle/answer_recall@k``, ``gflownet/answer_hit@k`` and the four
    scalars under the tables (NaN where a stage reported no value)."""
    retr, oracle, gfn = result["retriever"], result["oracle"], result["gflownet"]
    nan = float("nan")
    grid: dict[str, float] = {}
    for k in KS:
        grid[f"edge/recall@{k}"] = float(retr.get(f"edge/recall@{k}", nan))
        grid[f"answer/reachability@{k}"] = float(retr.get(f"answer/reachability@{k}", nan))
    for key in ("edge/score_margin", "edge/margin_positive_rate", "bridge/separation"):
        grid[key] = float(retr.get(key, nan))
    for k in KS:
        grid[f"oracle/answer_hit@{k}"] = float(oracle.get(f"answer_hit@{k}", nan))
        grid[f"oracle/answer_recall@{k}"] = float(oracle.get(f"answer_recall@{k}", nan))
    for k in ROLLOUT_PREFIXES:
        grid[f"gflownet/answer_hit@{k}"] = float(gfn.get(f"answer_hit@{k}", nan))
    grid["gflownet/log_reward"] = float(gfn.get("log_reward", nan))
    grid["gflownet/length_mean"] = float(gfn.get("length_mean", nan))
    return grid


def render(result: dict[str, Any], *, samples: int, emb: int) -> list[str]:
    """The JAX script's Markdown tables, from ``metric_grid``."""
    g = metric_grid(result)
    lines = [
        "# Self-measured quality baseline (synthetic KGQA), PyTorch port",
        "",
        f"Device: `{result['device']}` ({result['device_kind']}); {samples} train / {result['test_samples']} "
        f"test samples, emb={emb}; total wall time {result['elapsed_s']:.0f}s.",
        "",
        "## Retriever (held-out split)",
        "",
        "| k | edge recall@k | answer reachability@k |",
        "|---|---|---|",
    ]
    lines += [f"| {k} | {g[f'edge/recall@{k}']:.3f} | {g[f'answer/reachability@{k}']:.3f} |" for k in KS]
    lines += [
        "",
        f"Score margin {g['edge/score_margin']:.3f} (positive-margin rate "
        f"{g['edge/margin_positive_rate']:.3f}); bridge separation {g['bridge/separation']:.3f}.",
        "",
        "## Oracle upper bound over agent graphs",
        "",
        "| k | answer hit@k | answer recall@k |",
        "|---|---|---|",
    ]
    lines += [f"| {k} | {g[f'oracle/answer_hit@{k}']:.3f} | {g[f'oracle/answer_recall@{k}']:.3f} |" for k in KS]
    lines += [
        "",
        "## GFlowNet (best-of-k rollouts)",
        "",
        "| rollouts k | answer_hit@k |",
        "|---|---|",
    ]
    lines += [f"| {k} | {g[f'gflownet/answer_hit@{k}']:.3f} |" for k in ROLLOUT_PREFIXES]
    lines += [
        "",
        f"Mean sampled log-reward {g['gflownet/log_reward']:.3f}; mean path length "
        f"{g['gflownet/length_mean']:.2f}.",
        "",
    ]
    return lines


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--emb", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0, help="the retriever's and the GFlowNet's init and draws")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    result = run(samples=args.samples, emb=args.emb, epochs=args.epochs, seed=args.seed, device=args.device)
    lines = render(result, samples=args.samples, emb=args.emb)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines))
    print(json.dumps({"elapsed_s": round(result["elapsed_s"], 1), "out": str(out)}))
    print("\n".join(lines))
    print(json.dumps({"seed": args.seed, "device": result["device_kind"], "grid": metric_grid(result)}))
    return result


if __name__ == "__main__":
    main()

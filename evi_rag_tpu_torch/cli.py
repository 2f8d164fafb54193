"""Command line of the port: the ``train_retriever`` and ``serve`` tasks.

Usage::

    python -m evi_rag_tpu_torch.cli <task> [--configs-dir configs] [key=value ...]

Counterpart of ``evi_rag_tpu/cli.py``'s tasks of the same names, with the
same config keys, the same ``configs/`` directory and the same outputs in
the run dir: ``train_retriever`` writes ``ckpt/best`` and ``ckpt/last``
(``retriever.train.ckpt_dir``), ``metrics.jsonl`` and ``metrics.json``;
``serve`` writes ``<split>_serve.jsonl``, ``<split>.manifest.json`` and
``metrics.json``.  ``retriever.ckpt`` names a checkpoint in the port's format
(``train/checkpoint.py``), such as ``train_retriever``'s ``ckpt/best``.
``dataset.source`` is ``synthetic`` or ``normalized`` (a materialized split
from the JAX package's ``build``).  ``device=cpu`` runs on the CPU; the
default is the GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from evi_rag_tpu_torch.utils.config import ConfigError, get_dotted, load_config
from evi_rag_tpu_torch.utils.logging import get_logger, save_metrics_json
from evi_rag_tpu_torch.utils.run_context import make_run_dir, task_wrapper

log = get_logger("evi_rag_tpu_torch.cli")

DEFAULT_K_GRID = (1, 10, 25, 50, 100, 200, 300, 400, 500)


def _load_split(cfg: dict, split: str):
    """-> (samples, entity_emb, relation_emb, question_emb)."""
    ds = cfg.get("dataset", {})
    source = ds.get("source", "synthetic")
    if source == "synthetic":
        from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset

        seed = {"train": 0, "validation": 1, "test": 2}.get(split, 3) + int(ds.get("seed", 0))
        synth = make_synthetic_dataset(
            num_samples=int(ds.get("num_samples", 64)),
            emb_dim=int(ds.get("emb_dim", 64)),
            max_nodes=int(ds.get("max_nodes", 24)),
            seed=seed,
        )
        return synth.samples, synth.entity_emb, synth.relation_emb, synth.question_emb
    if source == "normalized":
        from evi_rag_tpu_torch.data.pipeline import load_retrieval_split

        root = pathlib.Path(ds["normalized_dir"])
        filter_ids = None
        if ds.get("filter"):
            payload = json.loads((root / ds["filter"]).read_text())
            filter_ids = set(payload["sample_ids"])
        samples, q_emb = load_retrieval_split(
            root, split, filter_ids=filter_ids,
            sample_limit=ds.get("sample_limit"), seed=int(ds.get("seed", 0)),
        )
        # Memory-map the embedding tables (dataset.mmap=false opts out).
        mode = "r" if ds.get("mmap", True) else None
        entity_emb = np.load(root / "embeddings" / "entity_embeddings.npy", mmap_mode=mode)
        relation_emb = np.load(root / "embeddings" / "relation_embeddings.npy", mmap_mode=mode)
        return samples, entity_emb, relation_emb, q_emb
    raise ConfigError(f"unknown dataset.source {source!r}")


def _vocab_maps(cfg: dict) -> tuple[dict[int, str], dict[int, str]]:
    """entity_id->label, relation_id->label from the normalized vocab parquet."""
    ds = cfg.get("dataset", {})
    if ds.get("source") != "normalized":
        return {}, {}
    import pyarrow.parquet as pq

    root = pathlib.Path(ds["normalized_dir"])
    ents = pq.read_table(root / "entity_vocab.parquet").to_pylist()
    rels = pq.read_table(root / "relation_vocab.parquet").to_pylist()
    return (
        {int(e["entity_id"]): str(e["label"]) for e in ents},
        {int(r["relation_id"]): str(r["label"]) for r in rels},
    )


def _parity_meta(cfg: dict) -> dict[str, int]:
    """The retriever's feature-geometry contract, from ``retriever.model``."""
    m = cfg.get("retriever", {}).get("model", {})
    return {
        "use_topic_pe": 1,
        "num_topics": 2,
        "dde_rounds": int(m.get("dde_rounds", 2)),
        "dde_reverse_rounds": int(m.get("dde_reverse_rounds", 2)),
    }


def _resolve_dim(value, inferred: int | None, name: str) -> int:
    if value == "auto" or value is None:
        if inferred is None:
            raise ConfigError(f"retriever.model.{name}=auto requires loaded embeddings")
        return int(inferred)
    return int(value)


def _retriever_model(cfg: dict, *, inferred_dim: int | None = None):
    from evi_rag_tpu_torch.models.retriever import Retriever

    m = cfg.get("retriever", {}).get("model", {})
    hs = m.get("hide_seek", {})
    emb_dim = _resolve_dim(m.get("emb_dim", 64), inferred_dim, "emb_dim")
    return Retriever(
        emb_dim=emb_dim,
        hidden_dim=_resolve_dim(m.get("hidden_dim", emb_dim), inferred_dim, "hidden_dim"),
        dde_rounds=int(m.get("dde_rounds", 2)),
        dde_reverse_rounds=int(m.get("dde_reverse_rounds", 2)),
        dropout_p=float(m.get("dropout_p", 0.1)),
        direction_mode=str(m.get("direction_mode", "bidirectional")),
        compute_dtype=str(m.get("compute_dtype", "float32")),
        hide_seek_enabled=bool(hs.get("enabled", False)),
        hide_seek_p_near=float(hs.get("p_near", 0.0)),
        hide_seek_p_far=float(hs.get("p_far", 0.0)),
        hide_seek_bias_near=float(hs.get("bias_near", 0.0)),
        hide_seek_bias_far=float(hs.get("bias_far", 0.0)),
    )


def _retriever_train_cfg(cfg: dict):
    from evi_rag_tpu_torch.models.losses import RetrieverLossConfig
    from evi_rag_tpu_torch.train.optim import OptimizerConfig
    from evi_rag_tpu_torch.train.retriever_trainer import RetrieverTrainConfig

    t = cfg.get("retriever", {}).get("train", {})
    o = t.get("optimizer", {})
    lo = t.get("loss", {})
    return RetrieverTrainConfig(
        loss=RetrieverLossConfig(
            infonce_temperature=float(lo.get("infonce_temperature", 1.0)),
            infonce_weight=float(lo.get("infonce_weight", 1.0)),
            bce_weight=float(lo.get("bce_weight", 0.0)),
            edge_weight_near=float(lo.get("edge_weight_near", 1.0)),
            edge_weight_bridge=float(lo.get("edge_weight_bridge", 1.0)),
        ),
        optimizer=OptimizerConfig(
            name=str(o.get("name", "adamw")),
            learning_rate=float(o.get("learning_rate", 1e-3)),
            weight_decay=float(o.get("weight_decay", 0.0)),
            grad_clip_norm=o.get("grad_clip_norm", 1.0),
            schedule=str(o.get("schedule", "constant")),
            warmup_steps=int(o.get("warmup_steps", 0)),
            total_steps=int(o.get("total_steps", 10_000)),
            groups=_param_groups(o.get("groups")),
        ),
        max_epochs=int(t.get("max_epochs", 5)),
        monitor=str(t.get("monitor", "answer/reachability@100")),
        monitor_mode=str(t.get("monitor_mode", "max")),
        patience=int(t.get("patience", 5)),
        k_values=tuple(int(k) for k in t.get("k_values", DEFAULT_K_GRID)),
        remat=bool(t.get("remat", False)),
    )


def _param_groups(raw) -> tuple:
    """Optimizer parameter groups (glob patterns over flax paths -> the
    optimizer), e.g. ``[{patterns: ["params/state_net_*/kernel"], optimizer: muon}]``."""
    from evi_rag_tpu_torch.train.optim import ParamGroup

    if not raw:
        return ()
    return tuple(
        ParamGroup(
            patterns=tuple(g["patterns"]),
            optimizer=str(g.get("optimizer", "adamw")),
            lr_scale=float(g.get("lr_scale", 1.0)),
            weight_decay=g.get("weight_decay"),
            momentum=float(g.get("momentum", 0.95)),
        )
        for g in raw
    )


def _enforce_sub_training_scope(cfg: dict, task: str) -> None:
    """Retriever training must run on the filtered sub dataset."""
    ds = cfg.get("dataset", {})
    if ds.get("source") != "normalized":
        return
    name = str(ds.get("name", ""))
    if not name.endswith("-sub"):
        raise ConfigError(
            f"{task} requires a '-sub' dataset variant (got {name!r}); pass dataset=<family>-sub"
        )
    if not ds.get("filter"):
        raise ConfigError(f"{task} requires dataset.filter (sub/nonzero filter json)")


@task_wrapper
def task_train_retriever(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Train the retriever (InfoNCE + optional BCE, AdamW / Muon groups) on
    the train split, select on the validation split, write ``ckpt/best``
    and ``ckpt/last`` (with the optimizer state) and ``metrics.json``."""
    from evi_rag_tpu_torch.data.feeder import collate_retriever, fixed_bucket_for, iter_stacked_batches
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.train.checkpoint import save_checkpoint
    from evi_rag_tpu_torch.train.retriever_trainer import evaluate, fit, make_eval_step
    from evi_rag_tpu_torch.utils.device import resolve_device
    from evi_rag_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(cfg.get("device"))
    _enforce_sub_training_scope(cfg, "train_retriever")
    tcfg = _retriever_train_cfg(cfg)
    t = cfg.get("retriever", {}).get("train", {})
    num_shards = int(t.get("num_shards", 1))
    per_shard = int(t.get("per_shard_batch", 8))
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if num_shards > cards:
        raise ConfigError(f"retriever.train.num_shards={num_shards} > available devices {cards}")
    if num_shards > 1:
        raise NotImplementedError(
            "retriever.train.num_shards > 1 needs data-parallel training over several cards, "
            "which is not ported yet (ROADMAP: sharded pooled path + data-parallel)"
        )

    train_samples, ent, rel, q_train = _load_split(cfg, "train")
    model = _retriever_model(cfg, inferred_dim=ent.shape[1])
    if model.emb_dim != ent.shape[1]:
        raise ConfigError(
            f"retriever.model.emb_dim={model.emb_dim} != embedding table dim "
            f"{ent.shape[1]}; set retriever.model.emb_dim=auto or rebuild"
        )
    val_samples, _, _, q_val = _load_split(cfg, "validation")
    bucket = fixed_bucket_for(list(train_samples) + list(val_samples), per_shard)
    # Device-resident tables (default on): batches carry int32 rows only.
    use_tables = bool(t.get("device_tables", True))
    tables = make_tables(ent, rel, device=device) if use_tables else None
    pin = device.type == "cuda"

    def train_batches(epoch: int):
        return iter_stacked_batches(
            train_samples, num_shards=num_shards, per_shard_batch=per_shard,
            entity_emb=ent, relation_emb=rel, question_emb=q_train,
            bucket=bucket, seed=epoch, id_feed=use_tables, pin=pin,
        )

    def val_batches():
        for i in range(0, len(val_samples), per_shard):
            yield collate_retriever(
                val_samples[i : i + per_shard], entity_emb=ent, relation_emb=rel,
                question_emb=q_val, bucket=bucket, id_feed=use_tables, pin=pin,
            )

    best_params, info = fit(
        model, tcfg, train_batches, val_batches,
        seed=int(t.get("seed", 0)), resume_from=t.get("resume_from"), tables=tables, device=device,
    )
    mlog = MetricLogger(run_dir)
    for h in info["history"]:
        mlog.log({**h["val"], "train_loss": h["train_loss"]}, step=h["epoch"])

    ckpt_dir = pathlib.Path(t.get("ckpt_dir", run_dir / "ckpt"))
    final_state = info["final_state"]
    digest = save_checkpoint(
        ckpt_dir / "best", best_params,
        meta={"parity_meta": model.parity_meta(), "monitor": tcfg.monitor, "score": info["best_score"]},
    )
    save_checkpoint(
        ckpt_dir / "last", final_state.params, meta={"parity_meta": model.parity_meta()},
        opt_state=final_state.opt_state, step=final_state.step,
    )
    final = evaluate(best_params, make_eval_step(model, tcfg, tables=tables), val_batches())
    metrics = {**final, "best_ckpt_sha256": digest, "epochs": len(info["history"])}
    save_metrics_json(run_dir / "metrics.json", metrics)
    log.info("train_retriever done: %s=%.4f", tcfg.monitor, final.get(tcfg.monitor, float("nan")))
    return metrics


def _load_retriever_ckpt(cfg: dict) -> tuple[Any, dict]:
    from evi_rag_tpu_torch.train.checkpoint import load_checkpoint

    ckpt = get_dotted(cfg, "retriever.ckpt")
    if not ckpt:
        raise ConfigError("retriever.ckpt is required")
    tree, meta = load_checkpoint(ckpt)
    return tree["params"], meta


@task_wrapper
def task_serve(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Checkpoint -> pre-projected index -> batched per-question top-k over
    each split, with measured q/s and triple recall@k."""
    from evi_rag_tpu_torch.eval.artifacts import write_manifest
    from evi_rag_tpu_torch.serving import project_tables, serve_recall_at_k, serve_split
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, export_retriever_features
    from evi_rag_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.get("device"))
    sv = cfg.get("serve", {})
    splits = list(sv.get("splits", ["test"]))
    k = int(sv.get("k", 100))
    group_size = int(sv.get("group_size", 16))
    dtype = torch.bfloat16 if str(sv.get("compute_dtype", "bfloat16")) == "bfloat16" else torch.float32
    k_grid = [int(v) for v in sv.get("k_values", DEFAULT_K_GRID) if int(v) <= k]
    if bool(sv.get("data_parallel", False)):
        raise NotImplementedError("serve.data_parallel is not ported yet")

    first_samples, ent, rel, q = _load_split(cfg, splits[0])
    params, _meta = _load_retriever_ckpt(cfg)
    exported = export_retriever_features(params, _parity_meta(cfg))
    bundle = {"features": bundle_from_numpy(exported["features"], device=device),
              "parity_meta": exported["parity_meta"]}
    pm = bundle["parity_meta"]

    t_proj = time.perf_counter()
    tables = project_tables(bundle, ent, rel, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    proj_s = round(time.perf_counter() - t_proj, 4)
    ent2label, rel2label = _vocab_maps(cfg)

    out: dict[str, Any] = {}
    for si, split in enumerate(splits):
        samples, ent_s, rel_s, q_emb = (
            (first_samples, ent, rel, q) if si == 0 else _load_split(cfg, split)
        )
        if not samples:
            continue
        # Normalized datasets share one table file across splits; synthetic
        # splits regenerate their tables per split.
        shares_tables = (
            cfg.get("dataset", {}).get("source") == "normalized"
            or (ent_s is ent and rel_s is rel)
        )
        split_tables = tables if shares_tables else None
        results, stats = serve_split(
            bundle, samples,
            entity_emb=ent_s, relation_emb=rel_s, question_emb=q_emb,
            k=k, num_rounds=int(pm["dde_rounds"]),
            num_reverse_rounds=int(pm["dde_reverse_rounds"]),
            group_size=group_size, dtype=dtype, projected=split_tables,
            fused_threshold=int(sv.get("fused_threshold", 256)),
            warmup=sv.get("warmup"), device=device,
        )
        out[f"{split}/num_questions"] = stats.num_questions
        out[f"{split}/queries_per_s"] = stats.queries_per_s
        out[f"{split}/scoring_s"] = stats.scoring_s
        out[f"{split}/index_build_s"] = (
            proj_s if split_tables is not None else stats.index_build_s
        )
        out[f"{split}/pack_s"] = stats.pack_s
        out[f"{split}/dispatch_s"] = stats.dispatch_s
        out[f"{split}/drain_s"] = stats.drain_s
        out[f"{split}/compile_s"] = stats.compile_s
        out.update({f"{split}/{m}": v for m, v in
                    serve_recall_at_k(samples, results, k_grid).items()})

        if bool(sv.get("write_jsonl", True)):
            by_id = {s.sample_id: s for s in samples}
            path = run_dir / f"{split}_serve.jsonl"
            with path.open("w") as f:
                for r in results:
                    s = by_id[r.sample_id]
                    ent_ids = (
                        s.node_entity_ids
                        if s.node_entity_ids is not None
                        else np.arange(s.num_nodes, dtype=np.int64)
                    )
                    triples = []
                    for e in r.edge_ids.tolist():
                        h = int(ent_ids[s.edge_index[0][e]])
                        rr = int(s.edge_relations[e])
                        t = int(ent_ids[s.edge_index[1][e]])
                        if ent2label:
                            triples.append([ent2label.get(h, str(h)), rel2label.get(rr, str(rr)),
                                            ent2label.get(t, str(t))])
                        else:
                            triples.append([h, rr, t])
                    f.write(json.dumps({
                        "sample_id": r.sample_id,
                        "scores": [round(float(v), 5) for v in r.scores.tolist()],
                        "triples": triples,
                    }) + "\n")
            write_manifest(
                run_dir, artifact="serve_topk", filename=path.name, split=split,
                extra={"k": k, "num_questions": stats.num_questions},
            )
            out[f"{split}/serve_jsonl"] = str(path)
    save_metrics_json(run_dir / "metrics.json", out)
    return out


TASKS: dict[str, Callable] = {
    "serve": task_serve,
    "train_retriever": task_train_retriever,
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="evi-rag-tpu-torch")
    parser.add_argument("task", choices=sorted(TASKS))
    parser.add_argument("--configs-dir", default="configs")
    parser.add_argument("--config", default=None, help="base config name (defaults to the task name)")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    # Intermixed: overrides may come before or after --configs-dir on every
    # Python 3 version (plain parse_args leaves them unrecognised on some).
    args = parser.parse_intermixed_args(argv)

    cfg = load_config(args.configs_dir, args.config or args.task, args.overrides)
    cfg.setdefault("task_name", args.task)
    cfg["_configs_dir"] = args.configs_dir
    run_dir = make_run_dir(cfg)
    log.info("task=%s run_dir=%s", args.task, run_dir)
    TASKS[args.task](cfg, run_dir=run_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command line of the port: all ten tasks of the JAX package, ``build``,
``train_retriever``, ``eval_retriever``, ``train_gflownet``,
``eval_gflownet``, ``bfs_chains``, ``reasoner``, ``sweep``, ``seed_stats``
and ``serve``.

Usage::

    python -m evi_rag_tpu_torch.cli <task> [--configs-dir configs] [key=value ...]

Counterpart of ``evi_rag_tpu/cli.py``'s tasks of the same names, with the
same config keys, the same ``configs/`` directory and the same outputs in
the run dir: ``train_retriever`` writes ``ckpt/best`` and ``ckpt/last``
(``retriever.train.ckpt_dir``), ``metrics.jsonl`` and ``metrics.json``;
``eval_retriever`` writes the ``g_agent/<split>`` store and
``eval_retriever/<split>.jsonl`` under ``eval.artifacts_dir``;
``train_gflownet`` trains on those stores (``gflownet.g_agent_dir``) and
writes ``ckpt/best`` (``gflownet.ckpt_dir``); ``eval_gflownet`` writes
``eval_gflownet/<split>.jsonl``; ``bfs_chains`` writes ``eval_bfs/<split>.jsonl``
from the agent stores; ``reasoner`` scores the agent stores with the oracle
or a chat backend and writes ``reasoner/<split>.jsonl``; ``sweep`` runs
trials of ``train_retriever`` or ``train_gflownet`` into ``trial_<i>/`` and
writes ``sweep.json``; ``seed_stats`` reports one-hop seed statistics;
``serve`` writes ``<split>_serve.jsonl``, ``<split>.manifest.json`` and
``metrics.json``.  ``retriever.ckpt`` and ``gflownet.ckpt`` name checkpoints in the port's
format (``train/checkpoint.py``), such as ``train_retriever``'s ``ckpt/best``.
``dataset.source`` is ``synthetic`` or ``normalized`` (a materialized split
from ``build``).  ``retriever.train.num_shards=N`` trains data-parallel,
one process per device: ``EVI_DISTRIBUTED=1 torchrun --nproc-per-node N
-m evi_rag_tpu_torch.cli train_retriever retriever.train.num_shards=N ...``
(or the ``EVI_COORDINATOR_ADDRESS`` / ``EVI_NUM_PROCESSES`` /
``EVI_PROCESS_ID`` variables, ``parallel.multihost``); only rank 0 writes
the checkpoints.  ``serve.data_parallel=true`` serves over every local card
in one process.  ``device=cpu`` runs on the CPU; the default is the GPU
(``seed_stats``, ``bfs_chains`` and ``reasoner`` run on the host only;
``sweep`` passes ``device`` to every trial).
"""

from __future__ import annotations

import argparse
import dataclasses
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


# Probe texts of the gte parity gate: a question, an entity, a relation and
# the empty string.
GTE_PARITY_PROBE = ("what is the capital of france", "Barack Obama", "people.person.place_of_birth", "")


def _text_encoder(enc_cfg: dict, device: torch.device):
    """The build's encoder for ``build.encoder``; ``gte_jax`` is the port's
    gte encoder, held to the HF reference by the parity gate."""
    from evi_rag_tpu_torch.data.text_encoder import HashTextEncoder, TorchHFTextEncoder

    kind = enc_cfg.get("kind", "hash")
    max_length = int(enc_cfg.get("max_length", 64))
    if kind == "hash":
        return HashTextEncoder(dim=int(enc_cfg.get("dim", 256)))
    if kind == "flax_hf":
        # The flax checkpoint's torch counterpart: the same HF weights through
        # AutoModel (from_pt does not apply to torch).
        return TorchHFTextEncoder(enc_cfg["model_path"], max_length=max_length, trust_remote_code=False,
                                  device=str(device))
    if kind == "torch_hf":
        return TorchHFTextEncoder(enc_cfg["model_path"], max_length=max_length,
                                  trust_remote_code=bool(enc_cfg.get("trust_remote_code", True)),
                                  device=str(device))
    if kind != "gte_jax":
        raise ConfigError(f"unknown build.encoder.kind {kind!r}")
    from evi_rag_tpu_torch.data.gte import GTETextEncoder, ReferenceEncoderUnavailable

    encoder = GTETextEncoder(enc_cfg["model_path"], max_length=max_length, device=str(device))
    if bool(enc_cfg.get("parity_check", True)):
        min_cos = float(enc_cfg.get("parity_min_cosine", 0.999))
        try:
            cos = encoder.parity_check(enc_cfg["model_path"], list(GTE_PARITY_PROBE))
        except ReferenceEncoderUnavailable as exc:
            # Only a reference that cannot be constructed downgrades the gate
            # to a loud skip; a failure while encoding or comparing refuses.
            log.warning(
                "gte parity_check SKIPPED (HF reference encoder unavailable: %s) -- the encoder is "
                "unverified against the upstream modeling code for this checkpoint", exc,
            )
        else:
            if cos < min_cos:
                raise ConfigError(
                    f"gte port parity FAILED: min cosine {cos:.6f} < {min_cos} vs the HF encoder on probe "
                    "texts; refusing to build with a diverging encoder "
                    "(set build.encoder.parity_check=false to override)"
                )
            log.info("gte parity_check ok: min cosine %.6f", cos)
    return encoder


def _pipeline_config(b: dict):
    """``PipelineConfig`` of the ``build`` section."""
    from evi_rag_tpu_torch.data.pipeline import PipelineConfig, SplitFilter, TextEntityPolicy

    def _filter(section: dict | None) -> SplitFilter:
        section = section or {}
        return SplitFilter(
            skip_no_topic=bool(section.get("skip_no_topic", False)),
            skip_no_ans=bool(section.get("skip_no_ans", False)),
            skip_no_path=bool(section.get("skip_no_path", False)),
        )

    tp = b.get("text_policy", {})
    fcfg = b.get("filter", {}) or {}
    return PipelineConfig(
        dataset=str(b["dataset"]),
        raw_root=str(b["raw_root"]),
        out_dir=str(b["out_dir"]),
        text_policy=TextEntityPolicy(
            mode=str(tp.get("mode", "all")),
            exclude_regex=tp.get("exclude_regex"),
            match_regex=tp.get("match_regex"),
        ),
        path_mode=str(b.get("path_mode", "undirected")),
        entity_normalization=str(b.get("entity_normalization", "none")),
        train_filter=_filter(fcfg.get("train")),
        eval_filter=_filter(fcfg.get("eval")),
        num_workers=int(b.get("num_workers", 0)),
    )


@task_wrapper
def task_build(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Raw parquet -> the normalized dataset (embeddings, split stores,
    parquet tables, filters) under ``build.out_dir``; the encoder runs on
    the GPU unless ``device=cpu``."""
    from evi_rag_tpu_torch.data.pipeline import build_pipeline
    from evi_rag_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.get("device"))
    b = cfg["build"]
    encoder = _text_encoder(b.get("encoder", {}), device)
    res = build_pipeline(_pipeline_config(b), encoder, column_map=b.get("column_map"))
    log.info("build: %s texts encoded in %.1f s, graphs built in %.1f s", res.num_texts,
             res.phase_s["encode_s"], res.phase_s["graph_s"])
    metrics = {
        "num_entities": res.num_entities,
        "num_relations": res.num_relations,
        "num_text_entities": res.num_text_entities,
        **{f"count/{k}/{s}": v for k, d in res.counts.items() for s, v in d.items()},
    }
    save_metrics_json(run_dir / "metrics.json", metrics)
    return metrics


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
    from evi_rag_tpu_torch.parallel.multihost import world_size

    tcfg = _retriever_train_cfg(cfg)
    t = cfg.get("retriever", {}).get("train", {})
    num_shards = int(t.get("num_shards", 1))
    per_shard = int(t.get("per_shard_batch", 8))
    # Data-parallel training runs one process per device: the group's ranks
    # are the available devices.
    ranks = world_size()
    if num_shards > ranks:
        raise ConfigError(
            f"retriever.train.num_shards={num_shards} > available devices {ranks} (one process per device): "
            f"launch EVI_DISTRIBUTED=1 torchrun --nproc-per-node {num_shards} -m evi_rag_tpu_torch.cli train_retriever "
            f"retriever.train.num_shards={num_shards} ..., or set EVI_COORDINATOR_ADDRESS / "
            "EVI_NUM_PROCESSES / EVI_PROCESS_ID")
    if ranks > 1 and num_shards != ranks:
        raise ConfigError(f"retriever.train.num_shards={num_shards} != the process group's {ranks} ranks")

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


def _enforce_single_process_eval(cfg: dict) -> None:
    """Eval metric aggregation is host-side and must not shard across
    processes (one process: ``torch.distributed`` not initialised, or a
    world of 1)."""
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
            and not cfg.get("eval", {}).get("allow_multiprocess", False)):
        raise ConfigError(
            "eval tasks require a single process (metric aggregation is "
            "host-side); set eval.allow_multiprocess=true to override"
        )


def _question_lookup(cfg: dict) -> dict[str, tuple[str, list[str] | None]]:
    ds = cfg.get("dataset", {})
    if ds.get("source") != "normalized":
        return {}
    import pyarrow.parquet as pq

    root = pathlib.Path(ds["normalized_dir"])
    rows = pq.read_table(root / "questions.parquet").to_pylist()
    return {r["graph_id"]: (r["question"], list(r.get("a_entity") or []) or None) for r in rows}


def _to_host(res: dict) -> dict:
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in res.items()}


@task_wrapper
def task_eval_retriever(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Evaluate a retriever checkpoint on each split in one forward pass
    that feeds the metrics, the ranking metrics and the artifacts: the
    ``g_agent/<split>`` store and ``eval_retriever/<split>.jsonl``."""
    from evi_rag_tpu_torch.data.feeder import collate_retriever, fixed_bucket_for
    from evi_rag_tpu_torch.data.g_agent import AgentSettings, build_agent_sample
    from evi_rag_tpu_torch.eval.artifacts import save_agent_store, topk_record_for_sample, write_topk_edges
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.train.retriever_trainer import evaluate, evaluate_results, make_eval_step
    from evi_rag_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.get("device"))
    _enforce_single_process_eval(cfg)
    # eval.datasets: dataset groups evaluated in sequence, each into its own
    # run and artifacts subdirectory.
    variants = cfg.get("eval", {}).get("datasets")
    if variants:
        import copy

        from evi_rag_tpu_torch.utils.config import _load_group

        combined: dict[str, Any] = {}
        for name in variants:
            sub_cfg = copy.deepcopy(cfg)
            sub_cfg["eval"] = dict(sub_cfg.get("eval", {}))
            sub_cfg["eval"].pop("datasets", None)
            sub_cfg["dataset"] = _load_group(pathlib.Path(cfg.get("_configs_dir", "configs")), "dataset", str(name))
            sub_dir = run_dir / str(name)
            sub_dir.mkdir(parents=True, exist_ok=True)
            sub_cfg["eval"]["artifacts_dir"] = str(
                pathlib.Path(cfg["eval"].get("artifacts_dir", run_dir / "artifacts")) / str(name))
            m = task_eval_retriever.__wrapped__(sub_cfg, run_dir=sub_dir)
            combined.update({f"{name}/{k}": v for k, v in m.items()})
        save_metrics_json(run_dir / "metrics.json", combined)
        return combined

    e = cfg.get("eval", {})
    splits = list(e.get("splits", ["validation", "test"]))
    _, first_ent, first_rel, _ = _load_split(cfg, splits[0])
    model = _retriever_model(cfg, inferred_dim=first_ent.shape[1]).to(device)
    params, _meta = _load_retriever_ckpt(cfg)
    tcfg = _retriever_train_cfg(cfg)
    artifacts_dir = pathlib.Path(e.get("artifacts_dir", run_dir / "artifacts"))
    ag = e.get("g_agent", {})
    settings = AgentSettings(
        edge_top_k=int(ag.get("edge_top_k", 500)),
        max_hops=int(ag.get("max_hops", 3)),
        apply_hop_filter=bool(ag.get("apply_hop_filter", False)),
        score_mode=str(ag.get("score_mode", "node_softmax")),
        allow_empty_answer=bool(ag.get("allow_empty_answer", True)),
        start_keep_ratio=float(ag.get("start_keep_ratio", 0.25)),
        start_min_edges=int(ag.get("start_min_edges", 1)),
        start_max_edges=int(ag["start_max_edges"]) if ag.get("start_max_edges") is not None else None,
    )
    # The device-resident tables come from the first split (as the JAX task
    # does; a normalized dataset shares one table file across splits).
    use_tables = bool(e.get("device_tables", True))
    tables = make_tables(first_ent, first_rel, device=device) if use_tables else None
    pin = device.type == "cuda"
    eval_step = make_eval_step(model, tcfg, tables=tables)
    per_batch = int(e.get("batch_size", 8))
    id2e, id2r = _vocab_maps(cfg)
    questions = _question_lookup(cfg)

    all_metrics: dict[str, Any] = {}
    for split in splits:
        samples, ent, rel, q = _load_split(cfg, split)
        if not samples:
            continue
        bucket = fixed_bucket_for(samples, per_batch)

        def batches():
            for i in range(0, len(samples), per_batch):
                yield collate_retriever(samples[i : i + per_batch], entity_emb=ent, relation_emb=rel,
                                        question_emb=q, bucket=bucket, id_feed=use_tables, pin=pin)

        write_artifacts = bool(e.get("write_artifacts", True))
        want_ranking = bool(e.get("ranking_metrics", True))
        if not (write_artifacts or want_ranking):
            # Metric-only mode: no materialization.
            split_metrics = evaluate(params, eval_step, batches())
            all_metrics.update({f"{split}/{k}": v for k, v in split_metrics.items()})
            continue

        # ONE forward pass per split feeds the metric accumulator and the
        # artifact / ranking builders.
        agent_samples, topk_records, rank_samples = [], [], []
        phase = {"collate_s": 0.0, "device_s": 0.0, "artifact_s": 0.0}

        def artifact_pass():
            # Dispatch-ahead: batch i + 1 is queued before batch i's results
            # are copied to the host, so the host's artifact building
            # overlaps the device; device_s is the time the host waits.
            pend = None  # (batch, res, chunk)
            i = 0
            it = batches()
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                phase["collate_s"] += time.perf_counter() - t0
                nxt = None
                if batch is not None:
                    t0 = time.perf_counter()
                    res = eval_step(params, batch)
                    phase["device_s"] += time.perf_counter() - t0
                    nxt = (batch, res, samples[i : i + per_batch])
                    i += per_batch
                if pend is not None:
                    pbatch, pres, pchunk = pend
                    t0 = time.perf_counter()
                    pres = _to_host(pres)
                    phase["device_s"] += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    collect(pbatch, pres, pchunk)
                    phase["artifact_s"] += time.perf_counter() - t0
                    yield pres
                if nxt is None:
                    break
                pend = nxt

        def collect(batch, res, chunk):
            scores, lf, lb = res["logits"], res["logits_fwd"], res["logits_bwd"]
            eb = batch.graph.edge_batch.numpy()
            emask = batch.graph.edge_mask.numpy()
            for g, s in enumerate(chunk):
                sel = np.nonzero((eb == g) & emask)[0]
                s_scores = scores[sel]
                ent_ids = s.node_entity_ids if s.node_entity_ids is not None else np.arange(s.num_nodes, dtype=np.int64)
                ans_ids = s.answer_entity_ids if s.answer_entity_ids is not None else ent_ids[s.answer_locals]
                if want_ranking:
                    rank_samples.append({
                        "scores": s_scores, "labels": s.edge_labels.astype(np.float32),
                        "answer_ids": np.asarray(ans_ids), "head_ids": ent_ids[s.edge_index[0]],
                        "tail_ids": ent_ids[s.edge_index[1]],
                    })
                if not write_artifacts:
                    continue
                a = build_agent_sample(
                    sample_id=s.sample_id, question_id=s.question_id, heads=s.edge_index[0],
                    tails=s.edge_index[1], relations=s.edge_relations, labels=s.edge_labels.astype(np.float32),
                    scores=s_scores, node_entity_ids=ent_ids, node_embedding_ids=s.node_embedding_ids,
                    start_entity_ids=ent_ids[s.topic_locals], answer_entity_ids=ans_ids, settings=settings,
                )
                if a is not None:
                    agent_samples.append(a)
                topk_records.append(topk_record_for_sample(
                    sample_id=s.sample_id, scores=s_scores, logits_fwd=lf[sel], logits_bwd=lb[sel],
                    heads_global=ent_ids[s.edge_index[0]], rels=np.asarray(s.edge_relations),
                    tails_global=ent_ids[s.edge_index[1]], k_values=tcfg.k_values,
                    labels=s.edge_labels.astype(np.float32), answer_entity_ids=ans_ids,
                    question=questions.get(s.sample_id, (None, None))[0],
                    id2entity=id2e or None, id2relation=id2r or None,
                ))

        split_metrics = evaluate_results(artifact_pass())
        all_metrics.update({f"{split}/{k}": v for k, v in split_metrics.items()})
        all_metrics.update({f"{split}/phase/{k}": round(v, 3) for k, v in phase.items()})
        if want_ranking and rank_samples:
            from evi_rag_tpu_torch.eval.ranking import compute_answer_hit, compute_answer_recall, compute_ranking_metrics

            stats = compute_ranking_metrics(rank_samples, tcfg.k_values)
            all_metrics.update({f"{split}/{k}": v for k, v in stats.as_flat_dict("ranking/").items()})
            all_metrics.update({f"{split}/{k}": v for k, v in compute_answer_recall(rank_samples, tcfg.k_values).items()})
            all_metrics.update({f"{split}/{k}": v for k, v in compute_answer_hit(rank_samples, tcfg.k_values).items()})
        if not write_artifacts:
            continue
        save_agent_store(agent_samples, artifacts_dir / "g_agent" / split, split=split,
                         settings_meta=dataclasses.asdict(settings))
        write_topk_edges(topk_records, artifacts_dir / "eval_retriever", split=split, k_values=tcfg.k_values)
        all_metrics[f"{split}/num_agent_samples"] = len(agent_samples)
    save_metrics_json(run_dir / "metrics.json", all_metrics)
    return all_metrics


def _gfn_cfg(cfg: dict, *, inferred_dim: int | None = None):
    from evi_rag_tpu_torch.models.gflownet.reward import RewardConfig
    from evi_rag_tpu_torch.train.gflownet_trainer import GFlowNetConfig
    from evi_rag_tpu_torch.train.optim import OptimizerConfig

    g = cfg.get("gflownet", {})
    r = g.get("reward", {})
    o = g.get("optimizer", {})
    return GFlowNetConfig(
        hidden_dim=_resolve_dim(g.get("hidden_dim", 64), inferred_dim, "hidden_dim"),
        max_steps=int(g.get("max_steps", 3)),
        stop_on_answer=bool(g.get("stop_on_answer", True)),
        policy_temperature=float(g.get("policy_temperature", 1.0)),
        eval_temperature=float(g.get("eval_temperature", 1.0)),
        num_train_rollouts=int(g.get("num_train_rollouts", 4)),
        use_state_dde=bool(g.get("use_state_dde", False)),
        reward=RewardConfig(
            success_reward=float(r.get("success_reward", 1.0)),
            failure_reward=float(r.get("failure_reward", 1e-4)),
            semantic_coef=float(r.get("semantic_coef", 1.0)),
            length_coef=float(r.get("length_coef", 1.0)),
        ),
        bc_weight=float(g.get("bc_weight", 0.0)),
        bc_hold_ratio=float(g.get("bc_hold_ratio", 0.0)),
        bc_decay_ratio=float(g.get("bc_decay_ratio", 0.0)),
        total_steps=int(g.get("total_steps", 1000)),
        eval_rollout_prefixes=tuple(int(k) for k in g.get("eval_rollout_prefixes", (1, 10, 25, 50, 100))),
        optimizer=OptimizerConfig(
            name=str(o.get("name", "adamw")),
            learning_rate=float(o.get("learning_rate", 1e-4)),
            grad_clip_norm=o.get("grad_clip_norm", 1.0),
        ),
        max_epochs=int(g.get("max_epochs", 5)),
        patience=int(g.get("patience", 5)),
        dropout=float(g.get("dropout", 0.1)),
        cache_frozen_embed=bool(g.get("cache_frozen_embed", False)),
        compute_dtype=str(g.get("compute_dtype", "float32")),
        precompute_policy=bool(g.get("precompute_policy", True)),
        # false | true | "dots"
        remat_policy=(lambda v: v if isinstance(v, str) else bool(v))(g.get("remat_policy", False)),
        sample_then_score=bool(g.get("sample_then_score", False)),
    )


def _agent_batches_fn(cfg: dict, split: str, batch_size: int, *, seed: int = 0, id_feed: bool = False,
                      pin: bool = False):
    """(agent samples, ``batches(epoch)``, (entity, relation) tables) of a
    split's g_agent store; the train split drops unreachable samples and is
    shuffled with ``default_rng([seed, epoch])``."""
    from evi_rag_tpu_torch.data.feeder import collate_agent, fixed_agent_bucket
    from evi_rag_tpu_torch.eval.artifacts import load_agent_store

    store_dir = pathlib.Path(cfg.get("gflownet", {})["g_agent_dir"]) / split
    agent_samples = load_agent_store(store_dir, drop_unreachable=split == "train")
    if not agent_samples:
        raise ConfigError(f"no agent samples in {store_dir}")
    _, ent, rel, q = _load_split(cfg, split)
    bucket = fixed_agent_bucket(agent_samples, batch_size)

    def batches(epoch: int = 0):
        order = np.arange(len(agent_samples))
        if split == "train":
            np.random.default_rng([seed, epoch]).shuffle(order)
        for i in range(0, len(order), batch_size):
            yield collate_agent([agent_samples[j] for j in order[i : i + batch_size]], entity_emb=ent,
                                relation_emb=rel, question_emb=q, bucket=bucket, id_feed=id_feed, pin=pin)

    return agent_samples, batches, (ent, rel)


def save_gflownet_checkpoint(path, params, bundle: dict, retriever_meta: dict, score) -> str:
    """``{"gflownet": params, "retriever_bundle": bundle}`` with
    ``retriever_meta`` (parity_meta + the retriever checkpoint's digest)."""
    from evi_rag_tpu_torch.train.checkpoint import save_checkpoint

    return save_checkpoint(path, {"gflownet": params, "retriever_bundle": bundle},
                           meta={"retriever_meta": retriever_meta, "score": score})


@task_wrapper
def task_train_gflownet(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Train the GFlowNet on the train split's g_agent store with the frozen
    retriever of ``retriever.ckpt``; select on the validation store."""
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.train.checkpoint import export_retriever_features, load_checkpoint
    from evi_rag_tpu_torch.train.gflownet_trainer import fit_gflownet
    from evi_rag_tpu_torch.utils.logging import MetricLogger
    from evi_rag_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.get("device"))
    _enforce_sub_training_scope(cfg, "train_gflownet")
    ckpt = get_dotted(cfg, "retriever.ckpt")
    if not ckpt:
        raise ConfigError("train_gflownet requires retriever.ckpt")
    tree, rmeta = load_checkpoint(ckpt)
    bundle = export_retriever_features(tree["params"], rmeta["parity_meta"])
    bundle_dim = int(np.asarray(bundle["features"]["q_gate"]["kernel"]).shape[0])
    gcfg = _gfn_cfg(cfg, inferred_dim=bundle_dim)
    if gcfg.hidden_dim != bundle_dim:
        raise ConfigError(f"gflownet.hidden_dim={gcfg.hidden_dim} != retriever feature dim {bundle_dim}; "
                          "set gflownet.hidden_dim=auto")
    g = cfg.get("gflownet", {})
    bs = int(g.get("batch_size", 8))
    run_seed = int(g.get("seed", 0))
    use_tables = bool(g.get("device_tables", True))
    pin = device.type == "cuda"
    _, train_batches, emb = _agent_batches_fn(cfg, "train", bs, seed=run_seed, id_feed=use_tables, pin=pin)
    _, val_batches, _ = _agent_batches_fn(cfg, "validation", bs, id_feed=use_tables, pin=pin)
    tables = make_tables(*emb, device=device) if use_tables else None

    best_params, info = fit_gflownet(gcfg, bundle, train_batches, lambda: val_batches(), seed=run_seed,
                                     tables=tables, device=device)
    ckpt_dir = pathlib.Path(g.get("ckpt_dir", run_dir / "ckpt"))
    retriever_meta = {"parity_meta": rmeta["parity_meta"], "retriever_ckpt_sha256": rmeta.get("params_sha256")}
    save_gflownet_checkpoint(ckpt_dir / "best", best_params, bundle, retriever_meta, info["best_score"])
    mlog = MetricLogger(run_dir)
    for h in info["history"]:
        mlog.log({**h["val"], "train_loss": h["train_loss"]}, step=h["epoch"])
    metrics = {"best_score": info["best_score"], "epochs": len(info["history"])}
    if info["history"]:
        metrics.update({f"final/{k}": v for k, v in info["history"][-1]["val"].items()})
    save_metrics_json(run_dir / "metrics.json", metrics)
    return metrics


@task_wrapper
def task_eval_gflownet(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Best-of-k rollouts of a GFlowNet checkpoint on each split's g_agent
    store: ``answer_hit@k`` metrics and ``eval_gflownet/<split>.jsonl``
    rollout + candidate-chain records from the same pass."""
    from evi_rag_tpu_torch.eval.artifacts import rollout_record_for_sample, write_rollout_records
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.train.checkpoint import load_checkpoint, validate_parity_meta
    from evi_rag_tpu_torch.train.gflownet_trainer import (
        build_modules, bundle_on, evaluate_gflownet_results, make_gfn_eval_step)
    from evi_rag_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.get("device"))
    ckpt = get_dotted(cfg, "gflownet.ckpt")
    if not ckpt:
        raise ConfigError("eval_gflownet requires gflownet.ckpt")
    tree, meta = load_checkpoint(ckpt)
    params = tree["params"]["gflownet"]
    bundle = bundle_on(tree["params"]["retriever_bundle"], device)
    # The feature-geometry contract is checked before any compute.
    recorded = (meta.get("retriever_meta") or {}).get("parity_meta")
    if recorded:
        validate_parity_meta({k: int(v) for k, v in recorded.items()}, bundle["parity_meta"])
    gcfg = _gfn_cfg(cfg, inferred_dim=int(bundle["features"]["q_gate"]["kernel"].shape[0]))
    modules = build_modules(gcfg).to(device)
    g = cfg.get("gflownet", {})
    bs = int(g.get("batch_size", 8))
    num_rollouts = int(g.get("eval_rollouts", max(gcfg.eval_rollout_prefixes)))
    splits = list(cfg.get("eval", {}).get("splits", ["validation", "test"]))
    artifacts_dir = pathlib.Path(cfg.get("eval", {}).get("artifacts_dir", run_dir / "artifacts"))
    id2e, id2r = _vocab_maps(cfg)
    use_tables = bool(g.get("device_tables", True))
    pin = device.type == "cuda"
    tables = None
    if use_tables:
        _, ent0, rel0, _ = _load_split(cfg, splits[0])
        tables = make_tables(ent0, rel0, device=device)
    eval_step = make_gfn_eval_step(modules, gcfg, bundle, num_rollouts=num_rollouts, tables=tables,
                                   collect_rollouts=True)
    all_metrics: dict[str, Any] = {}
    for split in splits:
        agent_samples, batches, _ = _agent_batches_fn(cfg, split, bs, id_feed=use_tables, pin=pin)
        records: list[dict] = []
        gen = torch.Generator(device=device).manual_seed(7)

        def results():
            idx = 0
            for batch in batches():
                res = eval_step(params, batch, gen)
                host = _to_host({k: res[k] for k in ("rollout_actions", "rollout_directions", "rollout_hits")})
                acts, dirs, hits = host["rollout_actions"], host["rollout_directions"], host["rollout_hits"]
                eptr = batch.graph.edge_ptr.numpy()
                n_real = int(batch.graph.graph_mask.sum())
                for gi in range(n_real):
                    local = np.where(acts[:, gi] >= 0, acts[:, gi] - eptr[gi], -1)
                    records.append(rollout_record_for_sample(
                        agent_samples[idx + gi], actions_local=local, directions=dirs[:, gi],
                        answer_hits=hits[:, gi].astype(bool), id2entity=id2e or None, id2relation=id2r or None))
                idx += n_real
                yield res

        m = evaluate_gflownet_results(results())
        all_metrics.update({f"{split}/{k}": v for k, v in m.items()})
        write_rollout_records(records, artifacts_dir / "eval_gflownet", split=split, num_rollouts=num_rollouts)
    save_metrics_json(run_dir / "metrics.json", all_metrics)
    return all_metrics


@task_wrapper
def task_serve(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Checkpoint -> pre-projected index -> batched per-question top-k over
    each split, with measured q/s and triple recall@k."""
    from evi_rag_tpu_torch.eval.artifacts import write_manifest
    from evi_rag_tpu_torch.parallel.mesh import make_mesh
    from evi_rag_tpu_torch.serving import project_tables, serve_recall_at_k, serve_split
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, export_retriever_features
    from evi_rag_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.get("device"))
    _enforce_single_process_eval(cfg)
    sv = cfg.get("serve", {})
    splits = list(sv.get("splits", ["test"]))
    k = int(sv.get("k", 100))
    group_size = int(sv.get("group_size", 16))
    dtype = torch.bfloat16 if str(sv.get("compute_dtype", "bfloat16")) == "bfloat16" else torch.float32
    k_grid = [int(v) for v in sv.get("k_values", DEFAULT_K_GRID) if int(v) <= k]
    mesh = None
    if bool(sv.get("data_parallel", False)):
        # Every local card, one process (the CPU alone when it is named).
        mesh = make_mesh() if device.type == "cuda" else make_mesh(devices=[device])

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
            group_size=group_size, dtype=dtype, projected=split_tables, mesh=mesh,
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


@task_wrapper
def task_bfs_chains(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """The non-learned BFS chain baseline over the agent stores
    (``gflownet.g_agent_dir/<split>``): ``eval_bfs/<split>.jsonl`` and its
    manifest under ``eval.artifacts_dir``.  Host only."""
    from evi_rag_tpu_torch.data.chains import ChainSettings, build_bfs_candidate_chains, textualize_chain
    from evi_rag_tpu_torch.eval.artifacts import load_agent_store, write_manifest

    b = cfg.get("bfs_chains", {})
    settings = ChainSettings(
        max_chain_length=int(b.get("max_chain_length", 3)),
        max_chains_per_sample=int(b.get("max_chains_per_sample", 100)),
        allow_backward=bool(b.get("allow_backward", True)),
    )
    splits = list(cfg.get("eval", {}).get("splits", ["test"]))
    artifacts_dir = pathlib.Path(cfg.get("eval", {}).get("artifacts_dir", run_dir / "artifacts"))
    id2e, id2r = _vocab_maps(cfg)
    out_metrics = {}
    for split in splits:
        store_dir = pathlib.Path(cfg["gflownet"]["g_agent_dir"]) / split
        samples = load_agent_store(store_dir)
        out_dir = artifacts_dir / "eval_bfs"
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{split}.jsonl"
        n = 0
        with path.open("w") as f:
            for s in samples:
                chains = build_bfs_candidate_chains(
                    num_nodes=s.num_nodes, heads=s.edge_head_locals, tails=s.edge_tail_locals,
                    relations=s.edge_relations, scores=s.edge_scores,
                    node_entity_ids=s.node_entity_ids, start_nodes=s.start_node_locals,
                    settings=settings,
                )
                if id2e:
                    for c in chains:
                        c["chain_text"] = textualize_chain(c, id2entity=id2e, id2relation=id2r)
                rec = {
                    "sample_id": s.sample_id,
                    "candidate_chains": [
                        {k: v for k, v in c.items() if k != "signature"} for c in chains
                    ],
                }
                f.write(json.dumps(rec) + "\n")
                n += 1
        write_manifest(out_dir, artifact="eval_bfs", filename=path.name, split=split)
        out_metrics[f"{split}/num_samples"] = n
    save_metrics_json(run_dir / "metrics.json", out_metrics)
    return out_metrics


@task_wrapper
def task_reasoner(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """The reasoner over each split's g_agent store (``gflownet.g_agent_dir``):
    ``oracle`` mode scores the ranked edges' answer hit/recall@k; ``llm``
    mode builds prompts from the ranked triplets or from candidate chains
    (``prompt_source=paths``: ``eval_gflownet`` rollouts or ``eval_bfs``
    chains), asks the chat backend, and writes
    ``reasoner/<split>.jsonl`` and its ``.metrics.json`` under
    ``eval.artifacts_dir``.  Host only."""
    from evi_rag_tpu_torch.eval.artifacts import load_agent_store
    from evi_rag_tpu_torch.eval.llm_client import LLMConfig, init_llm
    from evi_rag_tpu_torch.eval.reasoner import ReasonerSettings, build_triplet_records, run_reasoner

    r = cfg.get("reasoner", {})
    mode = str(r.get("mode", "oracle"))
    prompt_source = str(r.get("prompt_source", "triplets"))  # triplets | paths
    splits = list(cfg.get("eval", {}).get("splits", ["test"]))
    artifacts_dir = pathlib.Path(cfg.get("eval", {}).get("artifacts_dir", run_dir / "artifacts"))
    id2e, id2r = _vocab_maps(cfg)
    settings = ReasonerSettings(
        window_k=tuple(int(k) for k in r.get("window_k", DEFAULT_K_GRID)),
        token_budget=r.get("token_budget"),
        path_limit=int(r.get("path_limit", 10)),
    )
    all_metrics: dict[str, Any] = {}
    for split in splits:
        samples = load_agent_store(pathlib.Path(cfg["gflownet"]["g_agent_dir"]) / split)
        if mode == "oracle":
            oracle_inputs = []
            for s in samples:
                order = np.argsort(-s.edge_scores, kind="stable")
                oracle_inputs.append({
                    "head_entity_ids": s.node_entity_ids[s.edge_head_locals[order]],
                    "tail_entity_ids": s.node_entity_ids[s.edge_tail_locals[order]],
                    "answer_entity_ids": s.answer_entity_ids,
                })
            m = run_reasoner([], mode="oracle", oracle_inputs=oracle_inputs,
                             k_values=[int(k) for k in r.get("k_values", (1, 10, 25, 50, 100))])
        else:
            mock_resp = r.get("mock_response", '{"answers": []}')
            if not isinstance(mock_resp, str):
                mock_resp = json.dumps(mock_resp)  # YAML may parse the JSON into a dict
            llm = init_llm(LLMConfig(
                model_name=str(r.get("model_name", "mock")),
                backend=str(r.get("backend", "mock")),
                temperature=float(r.get("temperature", 0.0)),
                max_tokens=int(r.get("max_tokens", 1024)),
                ollama_base_url=str(r.get("ollama_base_url", "http://localhost:11434")),
                ollama_timeout=float(r.get("ollama_timeout", 120.0)),
                mock_response=mock_resp,
            ))
            # Question text + gold answers from the normalized questions parquet.
            questions = _question_lookup(cfg)
            records = []
            if prompt_source == "paths":
                from evi_rag_tpu_torch.eval.artifacts import ROLLOUT_ARTIFACT, validate_manifest
                from evi_rag_tpu_torch.eval.reasoner import build_path_records

                chains_dir = pathlib.Path(r.get("chains_dir", artifacts_dir / "eval_gflownet"))
                validate_manifest(chains_dir, artifact=str(r.get("chains_artifact", ROLLOUT_ARTIFACT)), split=split)
                by_id: dict[str, list] = {}
                with (chains_dir / f"{split}.jsonl").open() as f:
                    for line in f:
                        rec = json.loads(line)
                        by_id[rec["sample_id"]] = rec.get("candidate_chains", [])
                for s in samples:
                    qtext, golds = questions.get(s.sample_id, (s.sample_id, None))
                    golds = golds or [id2e.get(int(a), str(a)) for a in s.answer_entity_ids]
                    records.append(build_path_records(
                        sample_id=s.sample_id, question_text=qtext, gold_answers=golds,
                        chains=by_id.get(s.sample_id, []), settings=settings,
                        pair_start_local=s.pair_start_local, pair_answer_local=s.pair_answer_local,
                        pair_shortest_len=s.pair_shortest_len,
                    ))
            else:
                for s in samples:
                    qtext, golds = questions.get(s.sample_id, (s.sample_id, None))
                    golds = golds or [id2e.get(int(a), str(a)) for a in s.answer_entity_ids]
                    records.extend(build_triplet_records(
                        s, question_text=qtext, gold_answers=golds,
                        id2entity=id2e or {int(i): str(i) for i in s.node_entity_ids},
                        id2relation=id2r or {int(i): str(i) for i in np.unique(s.edge_relations)},
                        settings=settings,
                    ))
            m = run_reasoner(records, mode="llm", llm=llm,
                             output_path=artifacts_dir / "reasoner" / f"{split}.jsonl")
        all_metrics.update({f"{split}/{k}": v for k, v in m.items()})
    save_metrics_json(run_dir / "metrics.json", all_metrics)
    return all_metrics


@task_wrapper
def task_sweep(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Hyperparameter search over a training task: ``sweep.task`` selects
    ``train_retriever`` (default) or ``train_gflownet``.  Trial i runs in
    ``trial_<i>/`` (its checkpoints under ``trial_<i>/ckpt`` unless the
    config names a ckpt_dir); ``sweep.json`` records every trial, a failed
    one with its error."""
    import gc

    from evi_rag_tpu_torch.train.sweep import run_sweep

    sw = cfg.get("sweep", {})
    space = sw.get("space")
    if not space:
        raise ConfigError("sweep.space is required")
    task_name = str(sw.get("task", "train_retriever"))
    objectives = {"train_retriever": task_train_retriever, "train_gflownet": task_train_gflownet}
    if task_name not in objectives:
        raise ConfigError(f"sweep.task must be one of {sorted(objectives)}; got {task_name!r}")
    task_fn = objectives[task_name]

    def objective(trial_cfg: dict) -> dict[str, float]:
        trial_dir = run_dir / f"trial_{len(list(run_dir.glob('trial_*')))}"
        trial_dir.mkdir(parents=True, exist_ok=True)
        try:
            return task_fn.__wrapped__(trial_cfg, run_dir=trial_dir)
        finally:
            gc.collect()  # the trial's model and tables go before the next trial builds its own

    result = run_sweep(
        cfg, space, objective,
        monitor=str(sw.get("monitor", "answer/reachability@100")),
        mode=str(sw.get("mode", "max")),
        strategy=str(sw.get("strategy", "random")),
        num_trials=int(sw.get("num_trials", 5)),
        seed=int(sw.get("seed", 0)),
        out_path=run_dir / "sweep.json",
    )
    best = result["best"] or {}
    metrics = {"best_score": best.get("score"), "num_trials": len(result["trials"])}
    save_metrics_json(run_dir / "metrics.json", metrics)
    return metrics


@task_wrapper
def task_seed_stats(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """One-hop seed diagnostics: per-seed incident-edge counts and positive
    ratios with percentiles.  Host only."""
    splits = list(cfg.get("eval", {}).get("splits", ["train"]))
    out: dict[str, Any] = {}
    for split in splits:
        samples, *_ = _load_split(cfg, split)
        edge_counts: list[int] = []
        pos_ratios: list[float] = []
        for s in samples:
            heads, tails = s.edge_index
            labels = np.asarray(s.edge_labels, dtype=np.float32)
            for seed_local in np.asarray(s.topic_locals):
                inc = (heads == seed_local) | (tails == seed_local)
                n = int(inc.sum())
                edge_counts.append(n)
                pos_ratios.append(float(labels[inc].mean()) if n else 0.0)
        if not edge_counts:
            continue
        for name, arr in (("onehop_edges", edge_counts), ("onehop_pos_ratio", pos_ratios)):
            a = np.asarray(arr, dtype=np.float64)
            out[f"{split}/{name}/mean"] = float(a.mean())
            for p in (50, 90, 99):
                out[f"{split}/{name}/p{p}"] = float(np.percentile(a, p))
    save_metrics_json(run_dir / "metrics.json", out)
    return out


TASKS: dict[str, Callable] = {
    "build": task_build,
    "train_retriever": task_train_retriever,
    "eval_retriever": task_eval_retriever,
    "train_gflownet": task_train_gflownet,
    "eval_gflownet": task_eval_gflownet,
    "bfs_chains": task_bfs_chains,
    "reasoner": task_reasoner,
    "sweep": task_sweep,
    "seed_stats": task_seed_stats,
    "serve": task_serve,
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

    # A no-op unless EVI_COORDINATOR_ADDRESS or EVI_DISTRIBUTED is set: see
    # parallel/multihost.py.
    from evi_rag_tpu_torch.parallel.multihost import initialize_distributed

    initialize_distributed()
    cfg = load_config(args.configs_dir, args.config or args.task, args.overrides)
    cfg.setdefault("task_name", args.task)
    cfg["_configs_dir"] = args.configs_dir
    run_dir = make_run_dir(cfg)
    log.info("task=%s run_dir=%s", args.task, run_dir)
    TASKS[args.task](cfg, run_dir=run_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fixed checks shared by ``chip_smoke.py``, ``scripts/small_train_gain.py``
and the tests.

``SMALL_TRAIN_OVERRIDES`` is the small synthetic training setting of
``tests/test_train_retriever.py::test_train_improves_recall`` as
``train_retriever`` overrides (hidden 64, lr 3e-3, 8 epochs, dropout 0,
hide-and-seek off, T = 1, monitor ``edge/recall@5``; 16 questions a step,
on one device), at EMB 64 where the test has 32: the per-question kernel
takes D % 64 == 0, and ``serve`` runs the trained checkpoint through it.
Training must raise the validation split's ``edge/recall@5`` over the
untrained parameters' by more than ``SMALL_TRAIN_MIN_GAIN``.

``card_vs_cpu_step`` / ``gfn_card_vs_cpu_step`` run one f32 train step of
the retriever / the GFlowNet on the card and on the CPU from the same
parameters, batch and draws.  ``sts_vs_canonical`` holds the GFlowNet's
sample-then-score rollout to the canonical step loop on one batch and one
set of draws; ``gumbel_margin`` is its diagnostic for a graph whose action
differs.

``output_digest`` hashes a task's output files without what varies from
run to run (the debug profile's runs are held to the plain run by it).

``pqt_digest`` runs ``per_question_topk`` on a fixed input made with numpy
from seeds and hashes its output; ``PQT_DIGEST`` pins that hash for the
wgmma kernel (``csrc/twin_wgmma.cuh``, ``wg_kernel<kQuestion>``), so a match
shows that its output on the fixed input is bit for bit the same from run to
run and from change to change.  A change that moves an f32 sum order moves
the digest: it is re-pinned only after the kernel is held to its plain
version again.  Needs the card.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import zlib
from typing import Iterator

import numpy as np
import torch

from evi_rag_tpu_torch import cli
from evi_rag_tpu_torch.data.feeder import collate_retriever, collate_stacked, fixed_bucket_for
from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
from evi_rag_tpu_torch.models.batches import make_tables
from evi_rag_tpu_torch.models.retriever import Retriever
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.ops.graph import batch_to
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, flatten_tree
from evi_rag_tpu_torch.train.optim import OptimizerConfig
from evi_rag_tpu_torch.train.retriever_trainer import (
    RetrieverTrainConfig, create_train_state, evaluate, loss_and_grads, make_eval_step)
from evi_rag_tpu_torch.utils.config import load_config

SMALL_TRAIN_OVERRIDES = (
    "dataset.num_samples=48", "dataset.emb_dim=64", "dataset.max_nodes=16",
    "retriever.model.emb_dim=64", "retriever.model.hidden_dim=64", "retriever.model.dropout_p=0.0",
    "retriever.model.hide_seek.enabled=false", "retriever.train.loss.infonce_temperature=1.0",
    "retriever.train.optimizer.learning_rate=3e-3", "retriever.train.max_epochs=8",
    "retriever.train.patience=8", "retriever.train.monitor=edge/recall@5",
    "retriever.train.k_values=[1,5,10]", "retriever.train.per_shard_batch=16",
)
SMALL_TRAIN_MIN_GAIN = 0.05

# sha256 of the (vals, ids) bytes, taken on an NVIDIA H100 80GB HBM3.
PQT_DIGEST = "ff4e80525b8ded1f42bd6c7fcdd02ea20406a5c39338572e2ff3403d2b974beb"


def pqt_digest(dev) -> str:
    """sha256 of ``per_question_topk``'s output on a fixed input made with
    numpy from seeds (D = H = 1024, G = 4, M = 512, lengths 512 / 300 / 37 /
    0, k = 100, weights with random biases and LayerNorm affines)."""
    d, g, m = 1024, 4, 512
    wr = np.random.default_rng(17)
    dense = lambda i, o: {"kernel": (wr.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                          "bias": (0.1 * wr.normal(size=o)).astype(np.float32)}
    ln = lambda n: {"scale": (1 + 0.1 * wr.normal(size=n)).astype(np.float32),
                    "bias": (0.1 * wr.normal(size=n)).astype(np.float32)}
    feats = {
        "query_proj": {"proj": dense(d, d)}, "q_gate": dense(d, d), "q_bias": dense(d, d),
        "struct_proj": dense(20, d), "struct_norm": ln(d), "struct_gate": dense(d, 1),
        "state_net_0": dense(3 * d + 1, d), "state_norm": ln(d),
        "state_net_1": dense(d, d), "score_head": dense(d, 1),
    }
    bundle = {"features": bundle_from_numpy(feats, device=dev)}
    rng = np.random.default_rng(17)
    rows = lambda: torch.as_tensor(np.tanh(rng.normal(size=(g, m, d))), dtype=torch.bfloat16, device=dev)
    q = torch.as_tensor(rng.normal(size=(g, d)), dtype=torch.float32, device=dev)
    h, r, t = rows(), rows(), rows()
    s = torch.as_tensor(rng.random((g, m, 20)), dtype=torch.bfloat16, device=dev)
    lengths = torch.as_tensor(np.array([m, 300, 37, 0], np.int32), device=dev)
    vals, ids = sk.per_question_topk(bundle, q, h, r, t, s, lengths, k=100)
    return hashlib.sha256(vals.cpu().numpy().tobytes() + ids.cpu().numpy().tobytes()).hexdigest()


def small_train_gain(configs_dir, out_dir, device) -> dict:
    """Run ``train_retriever`` with ``SMALL_TRAIN_OVERRIDES`` on ``device``
    (writing under ``out_dir``), and evaluate the untrained parameters of the
    same seed on the same validation batches.  Returns the validation
    ``edge/recall@5`` before and after, the gain, the run's metrics and its
    checkpoint directory."""
    out = pathlib.Path(out_dir)
    dev = torch.device(device)
    ckpt = out / "ckpt"
    overrides = [*SMALL_TRAIN_OVERRIDES, f"device={dev.type}", f"retriever.train.ckpt_dir={ckpt}",
                 f"paths.log_dir={out / 'logs'}"]
    if cli.main(["train_retriever", "--configs-dir", str(configs_dir), *overrides]) != 0:
        raise RuntimeError("train_retriever failed")
    metrics = json.loads(sorted((out / "logs").glob("**/metrics.json"))[-1].read_text())

    cfg = load_config(str(configs_dir), "train_retriever", overrides)
    train, ent, rel, _ = cli._load_split(cfg, "train")
    val, _, _, q_val = cli._load_split(cfg, "validation")
    per = int(cfg["retriever"]["train"]["per_shard_batch"])
    bucket = fixed_bucket_for(list(train) + list(val), per)
    tables = make_tables(ent, rel, device=dev)
    model = cli._retriever_model(cfg, inferred_dim=ent.shape[1])
    tcfg = cli._retriever_train_cfg(cfg)
    state, _ = create_train_state(model, None, tcfg, seed=int(cfg["retriever"]["train"].get("seed", 0)),
                                  device=dev)
    batches = (collate_retriever(val[i : i + per], entity_emb=ent, relation_emb=rel, question_emb=q_val,
                                 bucket=bucket, id_feed=True) for i in range(0, len(val), per))
    before = evaluate(state.params, make_eval_step(model, tcfg, tables=tables), batches)["edge/recall@5"]
    after = metrics["edge/recall@5"]
    return {"before": before, "after": after, "gain": after - before, "metrics": metrics, "ckpt": ckpt}


def _step_inputs(dim: int, questions: int, seed: int):
    ds = make_synthetic_dataset(num_samples=questions, emb_dim=dim, num_relations=64, num_entities=4096,
                                min_nodes=64, max_nodes=256, avg_extra_edges=3.0, seed=seed)
    return collate_stacked(ds.samples, num_shards=1, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                           question_emb=ds.question_emb, bucket=fixed_bucket_for(ds.samples, questions))


def card_vs_cpu_step(dim: int = 256, hidden: int = 256, questions: int = 4, seed: int = 0) -> dict:
    """One f32 train step (dropout 0, hide-and-seek off; the caller turns
    TF32 off) from the same parameters and batch on the card and on the CPU.
    Returns the loss's relative difference, the worst gradient leaf's
    ``max(|g_card - g_cpu| / (1e-5 + 1e-3 |g_cpu|))`` (<= 1 passes atol 1e-5 +
    rtol 1e-3), and the largest parameter difference after AdamW (lr 1e-4)
    applies the *CPU's* gradients on both devices."""
    batch = _step_inputs(dim, questions, seed)
    cfg = RetrieverTrainConfig(optimizer=OptimizerConfig(name="adamw", learning_rate=1e-4))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = Retriever(emb_dim=dim, hidden_dim=hidden, dropout_p=0.0)
        state, tx = create_train_state(model, None, cfg, seed=seed, device=dev)
        loss, _, grads = loss_and_grads(model, cfg, batch_to(batch, torch.device(dev)))
        runs[dev] = (state, tx, loss.item(), {k: g.detach().clone() for k, g in grads.items()})
    cpu_grads = runs["cpu"][3]
    grad_ratio = max(
        float(((runs["cuda"][3][k].cpu() - g).abs() / (1e-5 + 1e-3 * g.abs())).max()) for k, g in cpu_grads.items())
    after = {}
    for dev, (state, tx, _, _) in runs.items():
        params = flatten_tree(state.params)
        updates, _ = tx.update({k: g.to(dev) for k, g in cpu_grads.items()}, state.opt_state, params)
        after[dev] = {k: (params[k].detach() + updates[k]).cpu() for k in params}
    param_diff = max(float((after["cuda"][k] - v).abs().max()) for k, v in after["cpu"].items())
    loss_cpu, loss_card = runs["cpu"][2], runs["cuda"][2]
    return {"loss_cpu": loss_cpu, "loss_card": loss_card, "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu),
            "grad_ratio": grad_ratio, "param_diff": param_diff, "edges": int(batch.graph.edge_mask.sum())}


def bf16_card_step(dim: int = 1024, questions: int = 4, seed: int = 0) -> dict:
    """One bf16 train step on the card at width ``dim`` (D = H): the loss
    and the gradient norm, both of which must be finite."""
    batch = _step_inputs(dim, questions, seed)
    cfg = RetrieverTrainConfig()
    model = Retriever(emb_dim=dim, hidden_dim=dim, dropout_p=0.1, compute_dtype="bfloat16")
    state, _ = create_train_state(model, None, cfg, seed=seed, device="cuda")
    loss, _, grads = loss_and_grads(model, cfg, batch_to(batch, torch.device("cuda")), generator=state.generator)
    finite = all(bool(torch.isfinite(g).all()) for g in grads.values())
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values())))
    return {"loss": loss.item(), "grad_norm": norm, "grads_finite": finite}


def random_bundle(dim: int, seed: int = 0) -> dict:
    """A retriever feature bundle (numpy) of flax-initialised parameters."""
    from evi_rag_tpu_torch.models.retriever import init_parameters, params_to_numpy
    from evi_rag_tpu_torch.train.checkpoint import export_retriever_features

    model = Retriever(emb_dim=dim, hidden_dim=dim)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return export_retriever_features(params_to_numpy(model)["params"], model.parity_meta())


def agent_inputs(dim: int, questions: int, seed: int = 0, shards: int | None = None):
    """A dense agent batch of ``questions`` graphs from the realistic
    generator at width ``dim`` (random retriever scores, top 64 edges); with
    ``shards``, stacked as ``shards`` batches of ``questions / shards``
    (``collate_agent_stacked``)."""
    from evi_rag_tpu_torch.data.feeder import collate_agent, collate_agent_stacked, fixed_agent_bucket
    from evi_rag_tpu_torch.data.g_agent import AgentSettings, build_agent_sample

    ds = make_synthetic_dataset(num_samples=2 * questions, emb_dim=dim, num_relations=64, num_entities=4096,
                                min_nodes=32, max_nodes=128, avg_extra_edges=3.0, seed=seed)
    rng = np.random.default_rng(seed)
    samples = []
    for s in ds.samples:
        scores = (rng.normal(size=s.edge_index.shape[1]) + 2.0 * s.edge_labels).astype(np.float32)
        a = build_agent_sample(
            sample_id=s.sample_id, question_id=s.question_id, heads=s.edge_index[0], tails=s.edge_index[1],
            relations=s.edge_relations, labels=s.edge_labels.astype(np.float32), scores=scores,
            node_entity_ids=np.arange(s.num_nodes), node_embedding_ids=s.node_embedding_ids,
            start_entity_ids=s.topic_locals, answer_entity_ids=s.answer_locals,
            settings=AgentSettings(edge_top_k=64))
        if a is not None:
            samples.append(a)
    samples = samples[:questions]
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb)
    if shards:
        return collate_agent_stacked(samples, num_shards=shards, bucket=fixed_agent_bucket(samples, questions // shards),
                                     **kw)
    return collate_agent(samples, bucket=fixed_agent_bucket(samples, questions), **kw)


def gfn_card_vs_cpu_step(hidden: int = 64, questions: int = 4, seed: int = 0,
                         devices: tuple[str, str] = ("cpu", "cuda")) -> dict:
    """One f32 GFlowNet train step (4 rollouts, BC on, dropout 0; the caller
    turns TF32 off) from the same parameters, batch and Gumbel uniforms on
    the card and on the CPU.  The initial parameters get seeded noise on
    every leaf (scale 0.3): at init the zero-initialised heads tie every
    edge logit and leave the gradients behind them at exactly 0.  Returns
    the loss's relative difference, the worst gradient leaf's
    ``max(|g_card - g_cpu| / (1e-5 + 1e-3 |g_cpu|))``, the leaves whose
    reference gradient is all zero (``zero_grad_leaves``, empty when every
    leaf is exercised), the smallest leaf's ``max |g_cpu|`` and the largest
    parameter difference after AdamW (lr 1e-4) applies the CPU's gradients
    on both devices (``devices``: the reference first)."""
    from evi_rag_tpu_torch.models.batches import replicate_agent_batch
    from evi_rag_tpu_torch.models.gflownet.actor import make_rollout_draws
    from evi_rag_tpu_torch.train import gflownet_trainer as gt

    batch = agent_inputs(hidden, questions, seed)
    cfg = gt.GFlowNetConfig(hidden_dim=hidden, max_steps=3, num_train_rollouts=4, bc_weight=0.5, dropout=0.0,
                            optimizer=OptimizerConfig(name="adamw", learning_rate=1e-4))
    draws = make_rollout_draws(cfg.actor, replicate_agent_batch(batch, cfg.num_train_rollouts), hidden_dim=hidden,
                               dropout=0.0, train=True, sample=True, generator=torch.Generator().manual_seed(seed))
    bundle = random_bundle(hidden, seed)
    runs = []
    for dev in devices:
        d = torch.device(dev)
        modules = gt.build_modules(cfg)
        params = gt.init_gflownet_params(cfg, modules, seed=seed, device=d)
        noise = torch.Generator().manual_seed(seed + 7)
        with torch.no_grad():
            for _, p in modules.named_parameters():
                p.add_(0.3 * torch.randn(p.shape, generator=noise).to(d))
        tx = gt.setup_optimizer(cfg.optimizer, flatten_tree(params))
        loss, _ = gt.rollout_losses(modules, gt.bundle_on(bundle, d), batch_to(batch, d), cfg,
                                    num_rollouts=cfg.num_train_rollouts, bc_weight=0.5, temperature=1.0, train=True,
                                    draws={k: v.to(d) for k, v in draws.items()})
        loss.backward()
        grads = {gt.gflownet_path(n): p.grad.detach().clone() for n, p in modules.named_parameters()}
        runs.append((dev, params, tx, loss.item(), grads))
    cpu_grads = runs[0][4]
    grad_ratio = max(
        float(((runs[1][4][k].cpu() - g).abs() / (1e-5 + 1e-3 * g.abs())).max()) for k, g in cpu_grads.items())
    grad_max = {k: float(g.abs().max()) for k, g in cpu_grads.items()}
    after = []
    for dev, params, tx, _, _ in runs:
        flat = flatten_tree(params)
        updates, _ = tx.update({k: g.to(dev) for k, g in cpu_grads.items()}, tx.init(flat), flat)
        after.append({k: (flat[k].detach() + updates[k]).cpu() for k in flat})
    param_diff = max(float((after[1][k] - v).abs().max()) for k, v in after[0].items())
    loss_cpu, loss_card = runs[0][3], runs[1][3]
    return {"loss_cpu": loss_cpu, "loss_card": loss_card, "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu),
            "grad_ratio": grad_ratio, "zero_grad_leaves": sorted(k for k, v in grad_max.items() if v == 0.0),
            "min_leaf_grad": min(grad_max.values()), "param_diff": param_diff,
            "edges": int(batch.graph.edge_mask.sum())}


STS_TOL = dict(rtol=1e-4, atol=1e-5)        # rollout outputs, sample-then-score vs the canonical loop
STS_LOSS_TOL = dict(rtol=1e-3, atol=1e-4)   # one step's loss (tests/test_gflownet_sts.py's bar)
STS_MARGIN = 1e-5                           # a differing action needs a near tie: margin <= this x max(1, |score|)


def _tol_ratio(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 within the tolerance."""
    if got.numel() == 0:
        return 0.0
    return float(((got.double() - want.double()).abs() / (atol + rtol * want.double().abs())).max())


def sts_vs_canonical(cfg, modules, bundle, batch, draws: dict, *, bc_weight: float = 0.5) -> dict:
    """One train-mode ``rollout_losses`` of the canonical loop and one of
    the sample-then-score rollout (the same modules, batch on the modules'
    device and draws of the replicated batch).  Returns the graphs whose
    actions differ with each one's Gumbel margin at its first differing
    step (``gumbel_margin``), the worst ratio to ``STS_TOL`` of
    ``log_pf_steps``, ``state_emb_seq`` and the BC statistics over the
    graphs that agree, both losses and the loss's ratio to
    ``STS_LOSS_TOL``."""
    import dataclasses
    from unittest import mock

    from evi_rag_tpu_torch.models.gflownet import actor
    from evi_rag_tpu_torch.train import gflownet_trainer as gt

    runs = {}
    for sts in (False, True):
        seen = {}

        def recording(**kw):
            seen["kw"], seen["ro"] = kw, actor.rollout(**kw)
            return seen["ro"]

        c = dataclasses.replace(cfg, sample_then_score=sts)
        with mock.patch.object(gt, "rollout", recording), torch.no_grad():
            loss, _ = gt.rollout_losses(modules, bundle, batch, c, num_rollouts=c.num_train_rollouts,
                                        bc_weight=bc_weight, temperature=c.policy_temperature, train=True,
                                        draws=draws)
        runs[sts] = (loss.item(), seen["ro"], seen["kw"])
    (loss_c, ro_c, kw_c), (loss_s, ro_s, _) = runs[False], runs[True]
    a_c, a_s = ro_c["actions_seq"], ro_s["actions_seq"]
    same = (a_c == a_s).all(dim=1)
    differing = []
    for gi in torch.nonzero(~same).flatten().tolist():
        step = int(torch.nonzero(a_c[gi] != a_s[gi])[0])
        margin, score = gumbel_margin(kw_c, a_c, gi, step)
        differing.append(dict(graph=gi, step=step, canonical=int(a_c[gi, step]), sts=int(a_s[gi, step]),
                              margin=margin, score=score,
                              near_tie=margin <= STS_MARGIN * max(1.0, abs(score))))
    ratios = {}
    for k in ("log_pf_steps", "state_emb_seq", "bc_loss_per_graph", "bc_steps_per_graph", "log_pf"):
        ratios[k] = _tol_ratio(ro_s[k][same], ro_c[k][same], **STS_TOL)
    return dict(graphs=int(same.numel()), differing=differing, ratios=ratios, loss_canonical=loss_c,
                loss_sts=loss_s, loss_ratio=_tol_ratio(torch.tensor(loss_s), torch.tensor(loss_c), **STS_LOSS_TOL),
                acting_steps=int((a_c >= 0).sum()))


def gumbel_margin(kw: dict, actions: torch.Tensor, graph: int, step: int) -> tuple[float, float]:
    """(margin, best score): the gap between the two best Gumbel scores
    (normalised log-probs + Gumbel noise over the graph's valid edges and
    STOP) of ``graph`` at ``step`` of the canonical loop, on the trajectory
    ``actions`` [G, T] replayed up to that step; ``kw`` are the canonical
    ``actor.rollout``'s keyword arguments."""
    from evi_rag_tpu_torch.models.gflownet import actor
    from evi_rag_tpu_torch.models.gflownet.env import candidate_edge_masks, env_reset

    policy, enc, batch, embed, cfg = kw["policy"], kw["state_encoder"], kw["batch"], kw["embed"], kw["config"]
    draws, gb = kw["draws"], kw["batch"].graph
    eb, g = gb.edge_batch, gb.num_graphs
    with torch.no_grad():
        tokens = embed.edge_tokens.float()
        cache = enc.precompute(batch, node_tokens=embed.node_tokens.float(), question_tokens=embed.question_tokens.float())
        st = policy.precompute_steps(tokens, cfg.num_steps, train=kw["train"], keep_edge=draws.get("keep_edge"),
                                     keep_head=draws.get("keep_head"))
        state = env_reset(batch, max_steps=cfg.max_steps, hidden_dim=tokens.shape[1], stop_on_answer=cfg.stop_on_answer)
        for t in range(step + 1):
            fwd, bwd = candidate_edge_masks(state, batch, max_steps=cfg.max_steps)
            valid = (fwd | bwd) & ~state.used_edge_mask
            if t == step:
                el, sl, _ = policy.apply_precomputed(st.at(t), enc.encode_state(cache, state, batch), eb, valid)
                lp_e, lp_s, _ = actor.log_probs_edges(el, sl, eb, valid, g, cfg.policy_temperature)
                mine = valid & (eb.long() == graph)
                scores = torch.cat([(lp_e + actor._gumbel(draws["uniform_edge"][t]))[mine],
                                    (lp_s + actor._gumbel(draws["uniform_stop"][t]))[graph:graph + 1]])
                top = torch.topk(scores.double(), min(2, scores.numel())).values
                return (float(top[0] - top[1]) if top.numel() > 1 else float("inf")), float(top[0])
            state = actor.advance(state, batch, actions[:, t].to(torch.int32), tokens, t, cfg)
    raise AssertionError("unreachable")


# Keys that vary from run to run of one program: a manifest's time and
# producer, a metric log line's time, a task's phase timers
# (``<split>/phase/<name>_s``); and the run's config, which names its own
# log dir.
_RUN_KEYS = ("created_at", "producer", "_time")
_RUN_FILES = ("config.json",)


def _stable(node):
    if isinstance(node, dict):
        return {k: _stable(v) for k, v in node.items() if k not in _RUN_KEYS and "phase/" not in k}
    if isinstance(node, list):
        return [_stable(v) for v in node]
    return node


def output_digest(*roots) -> str:
    """sha256 of a task's outputs: every file under each root (or the
    root itself when it is a file) but ``_RUN_FILES``, in path order, names
    and bytes; JSON files (and each line of a JSON-lines file) without the
    keys that vary from run to run (``_RUN_KEYS``, phase timers)."""
    h = hashlib.sha256()
    for root in map(pathlib.Path, roots):
        files = [root] if root.is_file() else sorted(
            f for f in root.rglob("*") if f.is_file() and f.name not in _RUN_FILES)
        if not files:
            raise FileNotFoundError(f"no outputs under {root}")
        for f in files:
            h.update((f.name if f == root else f.relative_to(root).as_posix()).encode() + b"\0")
            data = f.read_bytes()
            if f.suffix == ".json":
                data = json.dumps(_stable(json.loads(data)), sort_keys=True).encode()
            elif f.suffix == ".jsonl":
                data = b"\n".join(json.dumps(_stable(json.loads(ln)), sort_keys=True).encode()
                                  for ln in data.splitlines() if ln.strip())
            h.update(data)
    return h.hexdigest()


# --------------------------------------------------------------------------- #
# The build's synthetic raw data and gte stand-ins
# --------------------------------------------------------------------------- #

_DOMAINS = ("film", "people", "location", "sports", "music", "government",
            "business", "education", "medicine", "award")
_PROPS = ("contained_by", "directed_by", "member_of", "born_in", "works_for",
          "plays_for", "capital_of", "genre", "spouse", "nationality",
          "parent", "founded", "position", "language", "currency")

# The script's presets: the reference split sizes, the global entity pool,
# the relations, the hop mix and the log-normal edge-count mean.
PRESETS = {
    "webqsp": dict(train=2826, validation=246, test=1628, pool=120_000, relations=600,
                   hop_mix=(0.35, 0.35, 0.30), lognorm_mean=7.1,
                   prefix={"train": "WebQTrn", "validation": "WebQVal", "test": "WebQTest"}),
    "cwq": dict(train=27_639, validation=3_519, test=3_531, pool=300_000, relations=800,
                hop_mix=(0.15, 0.45, 0.40), lognorm_mean=7.25,
                prefix={"train": "CWQTrn", "validation": "CWQVal", "test": "CWQTest"}),
}
EDGE_CAP = 6144


def _entity_pool(n: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Global entity names: ~25% CVT-style m./g. ids (non-text), the rest
    readable names."""
    is_cvt = rng.random(n) < 0.25
    names = np.empty(n, dtype=object)
    for i in range(n):
        if is_cvt[i]:
            names[i] = f"{'m' if rng.random() < 0.8 else 'g'}.0{i:06x}"
        else:
            names[i] = f"Entity {i} {_DOMAINS[i % len(_DOMAINS)].title()}"
    return names, is_cvt


def _relation_pool(n: int, rng: np.random.Generator) -> np.ndarray:
    rels = np.empty(n, dtype=object)
    for i in range(n):
        d = _DOMAINS[rng.integers(len(_DOMAINS))]
        t = _DOMAINS[rng.integers(len(_DOMAINS))]
        p = _PROPS[rng.integers(len(_PROPS))]
        rels[i] = f"{d}.{t}.{p}_{i}"
    return rels


def _edge_count(rng: np.random.Generator, cap: int, lognorm_mean: float) -> int:
    # Median ~1.2k, p95 ~4k triples at mean 7.1.
    return int(np.clip(rng.lognormal(mean=lognorm_mean, sigma=0.75), 24, cap))


def make_question(qid: str, rng: np.random.Generator, ent_names: np.ndarray, rel_names: np.ndarray, *,
                  edge_cap: int, hop_mix: tuple[float, float, float] = (0.35, 0.35, 0.30),
                  lognorm_mean: float = 7.1) -> dict:
    """One RoG row: 1-2 topics, 1-3 answers, a planted 1/2/3-hop chain to
    each answer whose undirected shortest path is exactly the hop count,
    distractor edges up to a log-normal edge count, and a question that
    names the chain's relations."""
    n_edges = _edge_count(rng, edge_cap, lognorm_mean)
    n_nodes = max(16, int(n_edges ** 0.78))
    node_ids = rng.choice(len(ent_names), size=n_nodes, replace=False)

    n_topics = 1 if rng.random() < 0.85 else 2
    n_answers = 1 + (rng.random() < 0.4) + (rng.random() < 0.15)
    hops = 1 + int(rng.choice(3, p=np.asarray(hop_mix) / sum(hop_mix)))
    n_mids = (hops - 1) * n_answers
    topics = node_ids[:n_topics]
    answers = node_ids[n_topics : n_topics + n_answers]
    mids = node_ids[n_topics + n_answers : n_topics + n_answers + n_mids]

    triples: list[list[str]] = []
    seen: set[tuple[int, int, int]] = set()
    # Answers of >=2-hop questions take no distractor edges; 3-hop questions
    # get no topic<->m2 edge, so the chain's middle edge is a bridge.
    protected = set(int(a) for a in answers) if hops >= 2 else set()
    forbidden_pairs: set[frozenset] = set()
    if hops == 3:
        last_mids = mids[n_answers:]
        forbidden_pairs = {frozenset((int(t), int(m))) for t in topics for m in last_mids}

    def add(h: int, r: int, t: int) -> bool:
        if h == t or (h, r, t) in seen:
            return False
        seen.add((h, r, t))
        triples.append([str(ent_names[h]), str(rel_names[r]), str(ent_names[t])])
        return True

    gold_rel = rng.integers(len(rel_names), size=1 + hops)
    for a_i, a in enumerate(answers):
        t = topics[a_i % n_topics]
        if hops == 1:
            add(int(t), int(gold_rel[0]), int(a))
        else:
            chain = [int(t)]
            chain += [int(mids[j * n_answers + a_i]) for j in range(hops - 1)]
            chain.append(int(a))
            for j in range(hops):
                add(chain[j], int(gold_rel[j]), chain[j + 1])

    hot = np.concatenate([topics, mids]) if hops >= 2 else np.concatenate([topics, answers])
    open_ids = np.array([i for i in node_ids if int(i) not in protected]) if protected else node_ids
    while len(triples) < n_edges:
        batch = min(1024, n_edges - len(triples))
        h_hot = rng.random(batch) < 0.35
        hs = np.where(h_hot, rng.choice(hot, size=batch), open_ids[rng.integers(len(open_ids), size=batch)])
        ts = open_ids[rng.integers(len(open_ids), size=batch)]
        rs = rng.integers(len(rel_names), size=batch)
        for h, r, t in zip(hs, rs, ts):
            if forbidden_pairs and frozenset((int(h), int(t))) in forbidden_pairs:
                continue
            add(int(h), int(r), int(t))

    rel_phrase = " then ".join(
        str(rel_names[int(gold_rel[j])]).replace(".", " ").replace("_", " ") for j in range(hops))
    return {
        "id": qid,
        "question": f"what is the {rel_phrase} of {ent_names[topics[0]]}?",
        "answer": [str(ent_names[a]) for a in answers],
        "q_entity": [str(ent_names[t]) for t in topics],
        "a_entity": [str(ent_names[a]) for a in answers],
        "graph": triples,
        "choices": [],
    }


def synthetic_rows(preset: str = "webqsp", *, seed: int = 0, counts: dict[str, int] | None = None,
                   pool: int | None = None, relations: int | None = None,
                   edge_cap: int = EDGE_CAP) -> Iterator[tuple[str, list[dict]]]:
    """``(split, rows)`` for train, validation and test in the script's
    order and random stream: the script's rows for the same seed and
    sizes.  ``counts`` replaces the preset's question count of the splits
    it names (0 skips a split); ``pool`` / ``relations`` resize the pools."""
    p = PRESETS[preset]
    rng = np.random.default_rng(seed)
    ent_names, _ = _entity_pool(p["pool"] if pool is None else pool, rng)
    rel_names = _relation_pool(p["relations"] if relations is None else relations, rng)
    for split in ("train", "validation", "test"):
        n = p[split] if counts is None or split not in counts else counts[split]
        if n:
            yield split, [make_question(f"{p['prefix'][split]}-{i}", rng, ent_names, rel_names, edge_cap=edge_cap,
                                        hop_mix=p["hop_mix"], lognorm_mean=p["lognorm_mean"]) for i in range(n)]


class HashTokenizer:
    """A stand-in for a BERT-style HF tokenizer in the call form that
    ``GTETextEncoder.encode`` uses (``padding="max_length"``, truncation,
    ``return_tensors="np"``): lower-cased word and punctuation pieces hashed
    (crc32) into ``[5, vocab_size)``, between ``[CLS]`` (2) and ``[SEP]``
    (3), padded with 0; ``input_ids`` and ``attention_mask`` as int64."""

    PAD, CLS, SEP, FIRST = 0, 2, 3, 5

    def __init__(self, vocab_size: int) -> None:
        self.vocab_size = int(vocab_size)

    def ids(self, text: str) -> list[int]:
        return [self.FIRST + zlib.crc32(w.encode()) % (self.vocab_size - self.FIRST)
                for w in re.findall(r"\w+|[^\w\s]", text.lower())]

    def __call__(self, texts, *, padding="max_length", truncation=True, max_length=64, return_tensors="np"):
        if padding != "max_length" or not truncation or return_tensors != "np":
            raise ValueError("HashTokenizer pads to max_length, truncates and returns numpy arrays only")
        ids = np.full((len(texts), max_length), self.PAD, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            row = [self.CLS, *self.ids(text)[: max_length - 2], self.SEP]
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def random_gte_state(cfg, seed: int = 0) -> dict[str, torch.Tensor]:
    """An f32 gte state dict (upstream keys, every bias present) from a
    seeded ``torch.Generator``: linear weights N(0, 1 / fan_in), embeddings
    N(0, 1), biases N(0, 0.02^2), LayerNorm scales 1 + N(0, 0.05^2) and
    shifts N(0, 0.05^2)."""
    g = torch.Generator().manual_seed(seed)
    normal = lambda *shape, std: torch.randn(*shape, generator=g) * std
    d, i = cfg.hidden_size, cfg.intermediate_size
    ln = lambda name: {f"{name}.weight": 1 + normal(d, std=0.05), f"{name}.bias": normal(d, std=0.05)}
    state = {"embeddings.word_embeddings.weight": normal(cfg.vocab_size, d, std=1.0),
             "embeddings.token_type_embeddings.weight": normal(cfg.type_vocab_size, d, std=1.0),
             **ln("embeddings.LayerNorm")}
    for layer in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{layer}"
        state.update({
            f"{p}.attention.qkv_proj.weight": normal(3 * d, d, std=d ** -0.5),
            f"{p}.attention.qkv_proj.bias": normal(3 * d, std=0.02),
            f"{p}.attention.o_proj.weight": normal(d, d, std=d ** -0.5),
            f"{p}.attention.o_proj.bias": normal(d, std=0.02),
            f"{p}.mlp.up_gate_proj.weight": normal(2 * i, d, std=d ** -0.5),
            f"{p}.mlp.down_proj.weight": normal(d, i, std=i ** -0.5),
            f"{p}.mlp.down_proj.bias": normal(d, std=0.02),
            **ln(f"{p}.attn_ln"), **ln(f"{p}.mlp_ln"),
        })
    return state

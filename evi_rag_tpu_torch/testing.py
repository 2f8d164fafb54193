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
parameters, batch and draws.

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


def agent_inputs(dim: int, questions: int, seed: int = 0):
    """A dense agent batch of ``questions`` graphs from the realistic
    generator at width ``dim`` (random retriever scores, top 64 edges)."""
    from evi_rag_tpu_torch.data.feeder import collate_agent, fixed_agent_bucket
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
    return collate_agent(samples, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                         question_emb=ds.question_emb, bucket=fixed_agent_bucket(samples, questions))


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

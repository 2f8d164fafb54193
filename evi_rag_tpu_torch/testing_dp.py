"""Data-parallel checks, one process per rank.

    python -m evi_rag_tpu_torch.testing_dp SPEC.json

Each rank joins the process group from the ``EVI_*`` variables
(``multihost.initialize_distributed``), runs the checks of the spec on its
device (``spec["device"]``: ``cpu``, or ``cuda``: card ``local rank %
cards``) and writes ``rank<r>.json`` and, for each training check,
``<name>_rank<r>.npz`` (the parameters after the steps, by flax path) under
``spec["out_dir"]``.  ``spawn`` starts the ranks on a free localhost port
and waits for them within a time limit; ``run_checks`` runs the checks in
the calling process, which with no process group is the single-process
reference.  ``chip_smoke.py`` phase 11e and ``tests/test_torch_dp_train.py``
drive it.

Checks (``spec["checks"]``: dicts with ``kind`` and ``name``):

* ``retriever_step`` -- ``Retriever(**model)`` trained for ``warmup`` +
  ``steps`` steps on one stacked batch of ``shards`` x ``per_shard``
  questions of ``make_synthetic_dataset(**dataset)`` (``id_feed``: table
  rows resolved from device tables), from the parameters in ``params`` (an
  npz by flax path) or else the seeded init: the last loss, the step times,
  the parameters;
* ``gflownet_step`` -- one GFlowNet step (``GFlowNetConfig(**cfg)``) on
  ``testing.agent_inputs(hidden, questions, seed, shards)`` or the batch
  saved at ``batch``, with the bundle in ``bundle`` (npz by path) or
  ``testing.random_bundle``, the parameters in ``params`` or the seeded init
  plus noise, and the shards' draws saved at ``draws`` or drawn from
  ``seed``;
* ``glue`` -- ``gather_records`` and ``main_process_only`` over the ranks,
  and ``serve`` and the eval tasks' check under the group, which must raise
  the single-process-eval ``ConfigError`` (unless ``eval.allow_multiprocess``).
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch

from evi_rag_tpu_torch.parallel.multihost import gather_records, initialize_distributed, main_process_only, world_size
from evi_rag_tpu_torch.utils.logging import process_index

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flat_numpy(params: Any) -> dict[str, np.ndarray]:
    from evi_rag_tpu_torch.train.checkpoint import flatten_tree

    return {k: v.detach().float().cpu().numpy() for k, v in flatten_tree(params).items()}


def _load_tree(path: str) -> dict[str, Any]:
    from evi_rag_tpu_torch.train.checkpoint import unflatten_tree

    with np.load(path) as npz:
        return unflatten_tree({k: npz[k] for k in npz.files})


def _timed_steps(step: Callable, state: Any, batch: Any, dev: torch.device, warmup: int, steps: int):
    for _ in range(warmup):
        state, _ = step(state, batch)
    _sync(dev)
    times, out = [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return state, out, times


def retriever_step(c: dict, dev: torch.device) -> tuple[dict, dict]:
    from evi_rag_tpu_torch.data.feeder import collate_stacked, fixed_bucket_for
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.models.losses import RetrieverLossConfig
    from evi_rag_tpu_torch.models.retriever import Retriever, load_params
    from evi_rag_tpu_torch.ops.graph import batch_to
    from evi_rag_tpu_torch.train.optim import OptimizerConfig
    from evi_rag_tpu_torch.train.retriever_trainer import RetrieverTrainConfig, create_train_state, make_train_step

    ds = make_synthetic_dataset(**c["dataset"])
    n = c["shards"] * c["per_shard"]
    samples = ds.samples[:n]
    id_feed = bool(c.get("id_feed", False))
    stacked = collate_stacked(samples, num_shards=c["shards"], entity_emb=ds.entity_emb,
                              relation_emb=ds.relation_emb, question_emb=ds.question_emb,
                              bucket=fixed_bucket_for(samples, c["per_shard"]), id_feed=id_feed)
    tables = make_tables(ds.entity_emb, ds.relation_emb, device=dev) if id_feed else None
    model = Retriever(**c["model"])
    cfg = RetrieverTrainConfig(loss=RetrieverLossConfig(**c.get("loss", {})),
                               optimizer=OptimizerConfig(**c.get("optimizer", {"name": "adamw", "learning_rate": 1e-4})))
    state, tx = create_train_state(model, None, cfg, seed=int(c.get("seed", 0)), device=dev)
    if c.get("params"):
        load_params(model, _load_tree(c["params"]))
    step = make_train_step(model, tx, cfg, tables=tables)
    state, out, times = _timed_steps(step, state, batch_to(stacked, dev), dev, int(c.get("warmup", 0)),
                                     int(c.get("steps", 1)))
    res = {"loss": float(out["loss"]), "grad_norm": float(out["grad_norm"]), "step_ms": times,
           "edges": int(stacked.graph.edge_mask.sum())}
    return res, _flat_numpy(state.params)


def gflownet_step(c: dict, dev: torch.device) -> tuple[dict, dict]:
    from evi_rag_tpu_torch import testing
    from evi_rag_tpu_torch.ops.graph import batch_to
    from evi_rag_tpu_torch.train import gflownet_trainer as gt
    from evi_rag_tpu_torch.train.checkpoint import flatten_tree
    from evi_rag_tpu_torch.train.optim import OptimizerConfig
    from evi_rag_tpu_torch.train.retriever_trainer import TrainState

    kw = dict(c["cfg"])
    cfg = gt.GFlowNetConfig(optimizer=OptimizerConfig(**kw.pop("optimizer")), **kw)
    seed = int(c.get("seed", 0))
    if c.get("batch"):
        batch = torch.load(c["batch"], weights_only=False)  # written by this package's caller
    else:
        batch = testing.agent_inputs(cfg.hidden_dim, c["questions"], seed, shards=c["shards"])
    shards = batch.question_emb.shape[0]
    bundle = _load_tree(c["bundle"]) if c.get("bundle") else testing.random_bundle(cfg.hidden_dim, seed)
    modules = gt.build_modules(cfg)
    params = gt.init_gflownet_params(cfg, modules, seed=seed, device=dev)
    if c.get("params"):
        gt.load_gflownet_params(modules, _load_tree(c["params"]))
    else:
        noise = torch.Generator().manual_seed(seed + 7)
        with torch.no_grad():
            for _, p in modules.named_parameters():
                p.add_(0.3 * torch.randn(p.shape, generator=noise).to(dev))
    if c.get("draws"):
        draws = torch.load(c["draws"], weights_only=False)
    else:
        gen = torch.Generator().manual_seed(seed + 1)
        draws = [gt.train_rollout_draws(cfg, batch.shard(i), gen) for i in range(shards)]
    draws = [{k: v.to(dev) for k, v in d.items()} for d in draws]
    tx = gt.setup_optimizer(cfg.optimizer, flatten_tree(params))
    state = TrainState(params=params, opt_state=tx.init(flatten_tree(params)), step=0, generator=None)
    step = gt.make_gfn_train_step(modules, tx, cfg, gt.bundle_on(bundle, dev))
    batch = batch_to(batch, dev)
    t0 = time.perf_counter()
    state, out = step(state, batch, draws=draws)
    _sync(dev)
    res = {"loss": float(out["loss"]), "step_ms": [(time.perf_counter() - t0) * 1e3],
           "edges": int(batch.graph.edge_mask.sum())}
    return res, _flat_numpy(state.params)


def glue(c: dict, dev: torch.device) -> tuple[dict, None]:
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.utils.config import ConfigError

    r = process_index()
    merged = gather_records([{"id": 0, "rank": r}, {"id": r + 1, "rank": r}], dedup_key=lambda x: x["id"])
    errors = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, call in (
            ("serve", lambda: cli.task_serve.__wrapped__({"device": dev.type, "retriever": {"ckpt": tmp}},
                                                         run_dir=pathlib.Path(tmp))),
            ("eval", lambda: cli._enforce_single_process_eval({})),
            ("eval_allowed", lambda: cli._enforce_single_process_eval({"eval": {"allow_multiprocess": True}})),
        ):
            try:
                call()
                errors[name] = None
            except ConfigError as e:
                errors[name] = str(e)
    return {"merged": merged, "errors": errors, "main_only": main_process_only(lambda: r)()}, None


CHECKS = {"retriever_step": retriever_step, "gflownet_step": gflownet_step, "glue": glue}


def run_checks(spec: dict) -> dict:
    """Run the spec's checks in this process (under its process group, if
    any); write ``rank<r>.json`` and the parameter files; return the row."""
    dev = torch.device("cpu") if spec["device"] == "cpu" else torch.device("cuda", torch.cuda.current_device())
    out = pathlib.Path(spec["out_dir"])
    out.mkdir(parents=True, exist_ok=True)
    r = process_index()
    row: dict[str, Any] = {"rank": r, "world": world_size(), "device": str(dev), "checks": {}}
    if world_size() > 1:
        row["backend"] = torch.distributed.get_backend()
    if dev.type == "cuda":
        row["card"] = torch.cuda.get_device_name(dev)
    for c in spec["checks"]:
        res, params = CHECKS[c["kind"]](c, dev)
        if params is not None:
            np.savez(out / f"{c['name']}_rank{r}.npz", **params)
        row["checks"][c["name"]] = res
    (out / f"rank{r}.json").write_text(json.dumps(row))
    return row


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: Callable[[int], list[str]], ranks: int, *, timeout_s: float, threads: int | None = None,
          env: dict[str, str] | None = None) -> list[tuple[int, str, str]]:
    """Start ``ranks`` processes (``argv(rank)``) joined by the ``EVI_*``
    variables on a free localhost port, and wait for all of them within
    ``timeout_s`` (then kill every one still running and raise).  Returns
    each rank's (exit code, stdout, stderr)."""
    port = free_port()
    procs = []
    for r in range(ranks):
        e = {**os.environ, **(env or {}), "EVI_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "EVI_NUM_PROCESSES": str(ranks), "EVI_PROCESS_ID": str(r),
             "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
        if threads is not None:
            e["OMP_NUM_THREADS"] = e["EVI_TORCH_THREADS"] = str(threads)
        procs.append(subprocess.Popen(argv(r), env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout_s
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def spawn_checks(spec: dict, ranks: int, *, timeout_s: float, threads: int | None = None) -> list[dict]:
    """Write the spec under its ``out_dir``, run it on ``ranks`` spawned
    ranks and return their rows (raises if a rank fails)."""
    out = pathlib.Path(spec["out_dir"])
    out.mkdir(parents=True, exist_ok=True)
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    results = spawn(lambda r: [sys.executable, "-m", "evi_rag_tpu_torch.testing_dp", str(path)], ranks,
                    timeout_s=timeout_s, threads=threads)
    for r, (rc, so, se) in enumerate(results):
        if rc != 0:
            raise RuntimeError(f"rank {r} exited {rc}:\n{so[-4000:]}\n{se[-4000:]}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(ranks)]


def main(argv: list[str]) -> int:
    spec = json.loads(pathlib.Path(argv[0]).read_text())
    if os.environ.get("EVI_TORCH_THREADS"):
        torch.set_num_threads(int(os.environ["EVI_TORCH_THREADS"]))
    initialize_distributed(timeout_s=spec.get("timeout_s"))
    try:
        run_checks(spec)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

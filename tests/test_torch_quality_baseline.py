"""The port's quality baseline (``evi_rag_tpu_torch.scripts.benchmark_quality``)
against the JAX script it ports (``scripts/benchmark_quality.py``).

At a tiny size both run their four stages (retriever -> agent graphs ->
GFlowNet -> oracle) on the CPU; the port's grid must have the JAX run's
keys, its Markdown tables the JAX tables' rows, and every rate in [0, 1].
The values are not compared: each package trains from its own init.

Run as a script, this file measures the seed spread that the port's
quality is held to (``PERF.md`` §2): both packages at the JAX script's
default setting (128 train / 32 test, emb 64, 10 retriever and 5 GFlowNet
epochs) at seeds 0, 1 and 2, on the CPU::

    JAX_PLATFORMS=cpu python tests/test_torch_quality_baseline.py [--seeds 0 1 2] [--out PATH]

It prints each package's min / max over the seeds of the four bar metrics
and the bar, JAX's [min - (max - min) - 0.03, max + (max - min) + 0.03],
and writes every grid to ``--out`` (JSON, default
``artifacts/quality/seed_spread.json``).  The JAX script runs unchanged:
only the ``seed`` its ``fit`` and ``fit_gflownet`` calls receive is
replaced.

With ``--chain`` it instead trains the retriever of
``chip_smoke.py --quality``'s chain with both packages' CLIs on the CPU, on
one dataset cut to size: ``scripts/make_synthetic_webqsp.py`` (seed 0)
with 512 train / 64 validation / 64 test questions, built once by the JAX
CLI with the hash encoder at D = 64, then ``train_retriever
experiment=webqsp_synth_hw dataset=webqsp_synth-sub`` at hidden 64 for 8
epochs, the lr schedule's warmup and length cut in the same proportion to
the run's steps, ``retriever.train.seed`` from ``--chain-seed``; it prints
each package's per-epoch validation metrics.  ``--chain-init shared`` starts
both CLIs from one set of parameters, made by JAX's init (the key and batch
shapes JAX's own ``fit`` would use) and saved by each package's
``save_checkpoint``, through ``retriever.train.resume_from``;
``--chain-init port`` does the same with the port's init (its
``init_parameters`` from the seed, as the port's ``fit`` draws it); the
default, ``own``, lets each package draw its own init.  ``--chain-dtype float32``
runs both at ``retriever.model.compute_dtype=float32`` (the config's is
bfloat16)::

    JAX_PLATFORMS=cpu python tests/test_torch_quality_baseline.py --chain --chain-seed 0 \
        [--chain-init own|shared|port] [--chain-dtype bfloat16|float32] --out PATH

``--chain --chain-agent`` goes on through the agent stage (``chain_agent``):
both packages' ``eval_retriever`` over the three splits, then
``train_gflownet`` (8 epochs, patience 8, ``gflownet.total_steps`` cut from
the config's 1000 in proportion to the train questions, ``gflownet.seed``
from ``--chain-seed``) and ``eval_gflownet`` (25 rollouts) for JAX, for the
port on JAX's store, retriever and GFlowNet init (shared), and for the port
on its own (own), each also on its initial parameters (the untrained
floor).  It prints each run's monitor, BC weight and train loss by epoch
and its final ``answer_hit@{1,10,25}`` beside the floor's.
``--chain-agent-summary OUT_S0 OUT_S1 ...`` reads those outputs and prints
the rule of ``PERF.md`` §6 (PR 13)::

    JAX_PLATFORMS=cpu python tests/test_torch_quality_baseline.py --chain --chain-agent --chain-seed 0 --out PATH
    python tests/test_torch_quality_baseline.py --chain-agent-summary PATH_S0 PATH_S1 PATH_S2

``--chain-agent-replay WORK --chain-seed S`` runs the port's shared agent
stage again with JAX's own draws (``chain_agent_replay``; JAX's half of the
chain is made in ``WORK`` first when it is not there) and prints both
packages' monitor and train loss by epoch and their evals::

    JAX_PLATFORMS=cpu python tests/test_torch_quality_baseline.py --chain-agent-replay WORK --chain-seed 1 --out PATH
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import math
import pathlib
import sys
from unittest import mock

REPO = pathlib.Path(__file__).resolve().parents[1]
BAR_METRICS = ("edge/recall@10", "answer/reachability@10", "oracle/answer_hit@10", "gflownet/answer_hit@4")
BAR_SLACK = 0.03
RATES = ("edge/recall@", "answer/reachability@", "oracle/answer_hit@", "oracle/answer_recall@",
         "gflownet/answer_hit@", "edge/margin_positive_rate")


def jax_quality(argv: list[str], seed: int) -> dict:
    """``scripts/benchmark_quality.py``'s ``main`` with ``argv``, its ``fit``
    and ``fit_gflownet`` called with ``seed``; returns what it measured in
    the shape of the port's ``run`` (plus the printed ``lines``)."""
    from evi_rag_tpu.eval import oracle as joracle
    from evi_rag_tpu.train import gflownet_trainer as jgfn
    from evi_rag_tpu.train import retriever_trainer as jtrain

    spec = importlib.util.spec_from_file_location("_jax_benchmark_quality", REPO / "scripts" / "benchmark_quality.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    seen: dict = {}
    fit, fit_gflownet, evaluate, aggregate = (jtrain.fit, jgfn.fit_gflownet, jtrain.evaluate,
                                              joracle.aggregate_oracle_metrics)

    def seeded_fit(*a, **kw):
        kw["seed"] = seed
        return fit(*a, **kw)

    def seeded_gfn(*a, **kw):
        kw["seed"] = seed
        params, info = fit_gflownet(*a, **kw)
        seen["gflownet"] = info["history"][-1]["val"] if info["history"] else {}
        return params, info

    def last_evaluate(*a, **kw):
        seen["retriever"] = evaluate(*a, **kw)
        return seen["retriever"]

    def oracle(*a, **kw):
        seen["oracle"] = aggregate(*a, **kw)
        return seen["oracle"]

    out = io.StringIO()
    with mock.patch.object(jtrain, "fit", seeded_fit), mock.patch.object(jgfn, "fit_gflownet", seeded_gfn), \
            mock.patch.object(jtrain, "evaluate", last_evaluate), \
            mock.patch.object(joracle, "aggregate_oracle_metrics", oracle), \
            mock.patch.object(sys, "argv", ["benchmark_quality.py", *argv]), contextlib.redirect_stdout(out):
        script.main()
    lines = out.getvalue().splitlines()[1:]  # after the {"elapsed_s": ...} line
    return dict(seen, lines=lines)


def _rows(lines: list[str]) -> list[str]:
    """The tables' headers and each row's first cell."""
    return [ln if ln.startswith("#") or ln.startswith("| k") or ln.startswith("| rollouts")
            else ln.split("|")[1].strip() for ln in lines if ln.startswith(("#", "|"))]


def test_port_grid_has_the_jax_scripts_keys_and_rows(tmp_path):
    from evi_rag_tpu_torch.scripts import benchmark_quality as port

    argv = ["--samples", "16", "--emb", "32", "--epochs", "1"]
    jax_run = jax_quality([*argv, "--out", str(tmp_path / "jax.md")], seed=0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = port.main([*argv, "--device", "cpu", "--out", str(tmp_path / "port.md")])
    printed = json.loads(buf.getvalue().splitlines()[-1])
    port_grid = port.metric_grid(result)
    jax_grid = port.metric_grid(jax_run)
    assert printed["grid"] == json.loads(json.dumps(port_grid))
    assert set(port_grid) == set(jax_grid)
    port_lines = (tmp_path / "port.md").read_text().splitlines()
    assert _rows(port_lines)[1:] == _rows(jax_run["lines"])[1:]  # titles differ by the package's name
    for grid in (port_grid, jax_grid):
        for key, v in grid.items():
            if key.startswith(RATES):
                assert 0.0 <= v <= 1.0, (key, v)
            else:
                assert math.isfinite(v), (key, v)


def spread(grids: list[dict]) -> dict[str, tuple[float, float]]:
    return {m: (min(g[m] for g in grids), max(g[m] for g in grids)) for m in BAR_METRICS}


def bar(jax_spread: dict[str, tuple[float, float]]) -> dict[str, tuple[float, float]]:
    """JAX's [min - (max - min) - 0.03, max + (max - min) + 0.03] per metric."""
    return {m: (lo - (hi - lo) - BAR_SLACK, hi + (hi - lo) + BAR_SLACK) for m, (lo, hi) in jax_spread.items()}


CHAIN_COUNTS = {"train": 512, "validation": 64, "test": 64}
# The card's chain: 2826 / 16 = 177 steps an epoch, 8 epochs, warmup 200 of
# a 2500-step cosine; here 512 / 16 = 32 steps an epoch.
CHAIN_STEPS = 8 * CHAIN_COUNTS["train"] // 16
CHAIN_SCHEDULE = (round(200 * CHAIN_STEPS / (8 * 177)), round(2500 * CHAIN_STEPS / (8 * 177)))


def shared_init(work: pathlib.Path, common: list[str], seed: int, source: str = "jax") -> dict[str, str]:
    """One package's initial parameters for the chain's model, saved by both
    packages; returns {package: checkpoint dir}.  ``jax``: ``key(seed)``
    over the shapes of a training batch, as JAX's ``fit`` draws them;
    ``port``: the port's ``init_parameters`` from a generator seeded
    ``seed``, as the port's ``fit`` draws them."""
    import jax
    import numpy as np
    import torch

    from evi_rag_tpu import cli as jcli
    from evi_rag_tpu.data.feeder import collate_retriever, fixed_bucket_for
    from evi_rag_tpu.train import checkpoint as jck
    from evi_rag_tpu_torch import cli as tcli
    from evi_rag_tpu_torch.models.retriever import init_parameters, params_to_numpy
    from evi_rag_tpu_torch.train import checkpoint as tck

    cfg = jcli.load_config(str(REPO / "configs"), "train_retriever", [a for a in common if "=" in a])
    samples, ent, rel, q = jcli._load_split(cfg, "train")
    model = jcli._retriever_model(cfg, inferred_dim=ent.shape[1])
    if source == "jax":
        per_shard = int(cfg["retriever"]["train"]["per_shard_batch"])
        batch = collate_retriever(samples[:per_shard], entity_emb=ent, relation_emb=rel, question_emb=q,
                                  bucket=fixed_bucket_for(samples, per_shard))
        params = jax.tree.map(np.asarray, model.init(jax.random.key(seed), batch))
    else:
        port_model = tcli._retriever_model(cfg, inferred_dim=ent.shape[1])
        init_parameters(port_model, torch.Generator().manual_seed(seed))
        params = params_to_numpy(port_model)
    meta = {"parity_meta": model.parity_meta()}
    dirs = {"jax": str(work / "init_jax"), "port": str(work / "init_port")}
    jck.save_checkpoint(dirs["jax"], params, meta=meta)
    tck.save_checkpoint(dirs["port"], params, meta=meta)
    return dirs


def chain_data(work: pathlib.Path) -> pathlib.Path:
    """The chain's cut dataset, built once by the JAX CLI (hash encoder, D =
    64) under ``work``; returns its normalized directory."""
    import subprocess

    from evi_rag_tpu import cli as jcli

    raw, root = work / "raw", work / "normalized"
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_synthetic_webqsp.py"), "--out", str(raw), "--seed",
                    "0", *(f"--{k}={v}" for k, v in CHAIN_COUNTS.items())], check=True)
    assert jcli.main(["build", "--configs-dir", str(REPO / "configs"), "build.dataset=webqsp_synth",
                      f"build.raw_root={raw}", f"build.out_dir={root}", "build.encoder.dim=64",
                      f"paths.log_dir={work / 'logs'}"]) in (0, None)
    return root


def chain_common(root: pathlib.Path, seed: int, dtype: str = "bfloat16") -> list[str]:
    """The overrides every stage of the chain gets."""
    warmup, total = CHAIN_SCHEDULE
    return ["--configs-dir", str(REPO / "configs"), "experiment=webqsp_synth_hw", "dataset=webqsp_synth-sub",
            f"dataset.normalized_dir={root}", "retriever.model.hidden_dim=64", "retriever.train.max_epochs=8",
            "retriever.train.patience=8", f"retriever.train.optimizer.warmup_steps={warmup}",
            f"retriever.train.optimizer.total_steps={total}", f"retriever.train.seed={seed}",
            f"retriever.model.compute_dtype={dtype}", "extras.print_config=false"]


def chain(work: pathlib.Path, seed: int, *, init: str = "own", dtype: str = "bfloat16",
          packages: tuple[str, ...] = ("jax", "port")) -> dict:
    """Both packages' (or ``packages``') ``train_retriever`` under
    ``experiment=webqsp_synth_hw`` on one JAX-built dataset, each with
    ``retriever.train.seed=seed``, from its own init or from one shared init
    (``shared_init``), at ``compute_dtype`` ``dtype``; returns {package:
    per-epoch metrics}.  The checkpoints stay in ``work / ckpt_<package>``."""
    from evi_rag_tpu import cli as jcli
    from evi_rag_tpu_torch import cli as tcli

    common = chain_common(chain_data(work), seed, dtype)
    starts = {} if init == "own" else shared_init(work, common, seed, source="jax" if init == "shared" else "port")
    out = {}
    for name, main_fn, extra in (("jax", jcli.main, []), ("port", tcli.main, ["device=cpu"])):
        if name not in packages:
            continue
        logs = work / f"logs_{name}"
        if name in starts:
            extra = [*extra, f"retriever.train.resume_from={starts[name]}"]
        assert main_fn(["train_retriever", *common, *extra, f"retriever.train.ckpt_dir={work / f'ckpt_{name}'}",
                        f"paths.log_dir={logs}"]) in (0, None)
        (history,) = logs.glob("**/metrics.jsonl")
        out[name] = [json.loads(ln) for ln in history.read_text().splitlines()]
    return out


# The card's GFlowNet stage: ``total_steps`` 1000 over 2826 / 8 = 353 steps
# an epoch (the BC hold ends 0.57 epochs in, the decay 2.26); here cut in
# the same proportion to the run's train questions.
AGENT_TOTAL_STEPS = round(1000 * CHAIN_COUNTS["train"] / 2826)
AGENT_EPOCHS = 8
AGENT_KS = (1, 10, 25)


@contextlib.contextmanager
def gflownet_init(package: str, init: dict):
    """Record JAX's GFlowNet init into ``init["params"]`` (``jax``), or
    start the port from it (``port``, through the converter)."""
    if package == "jax":
        import jax
        import numpy as np

        from evi_rag_tpu.train import gflownet_trainer as lib

        def patched(*a, **kw):
            params = real(*a, **kw)
            init["params"] = jax.tree.map(np.asarray, params)
            return params
    else:
        from evi_rag_tpu_torch.train import gflownet_trainer as lib

        def patched(cfg, modules, *a, **kw):
            real(cfg, modules, *a, **kw)
            lib.load_gflownet_params(modules, init["params"])
            return lib.gflownet_params_tree(modules)
    real = lib.init_gflownet_params
    with mock.patch.object(lib, "init_gflownet_params", patched):
        yield


def agent_stage(work: pathlib.Path, common: list[str], seed: int, package: str, tag: str,
                retriever_ckpt: pathlib.Path, g_agent_dir: pathlib.Path, init: dict | None = None) -> dict:
    """One package's ``train_gflownet`` (``AGENT_EPOCHS`` epochs, patience as
    many, ``gflownet.seed=seed``) and ``eval_gflownet`` of the checkpoint it
    keeps over validation and test, and the same eval of the initial
    parameters (``train_gflownet`` with 0 epochs keeps them): the untrained
    floor.  JAX records its init into ``init``; the port starts from
    ``init`` when it is given."""
    from _torch_gfn_common import recording_train_step

    from evi_rag_tpu import cli as jcli
    from evi_rag_tpu.train import gflownet_trainer as jgt
    from evi_rag_tpu_torch import cli as tcli
    from evi_rag_tpu_torch.train import gflownet_trainer as tgt

    main_fn, lib, extra = (jcli.main, jgt, []) if package == "jax" else (tcli.main, tgt, ["device=cpu"])
    gfn = [f"retriever.ckpt={retriever_ckpt}", f"gflownet.g_agent_dir={g_agent_dir}", f"gflownet.seed={seed}",
           f"gflownet.total_steps={AGENT_TOTAL_STEPS}", f"gflownet.patience={AGENT_EPOCHS}"]
    out: dict = {}
    for label, epochs in (("init", 0), ("trained", AGENT_EPOCHS)):
        run = work / f"gfn_{tag}_{label}"
        rows: list = []
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(lib, "make_gfn_train_step", recording_train_step(lib, rows)))
            if init is not None:
                stack.enter_context(gflownet_init(package, init))
            assert main_fn(["train_gflownet", *common, *extra, *gfn, f"gflownet.max_epochs={epochs}",
                            f"gflownet.ckpt_dir={run / 'ckpt'}", f"paths.log_dir={run / 'train_logs'}"]) in (0, None)
        assert main_fn(["eval_gflownet", *common, *extra, f"gflownet.ckpt={run / 'ckpt' / 'best'}",
                        f"gflownet.g_agent_dir={g_agent_dir}", "eval.splits=[validation, test]",
                        f"eval.artifacts_dir={run / 'art'}", f"paths.log_dir={run / 'eval_logs'}"]) in (0, None)
        (metrics,) = (run / "eval_logs").glob("**/metrics.json")
        history = [json.loads(ln) for path in (run / "train_logs").glob("**/metrics.jsonl")
                   for ln in path.read_text().splitlines()]
        out[label] = {"eval": json.loads(metrics.read_text()), "history": history, "steps": rows}
    return out


def chain_agent(work: pathlib.Path, seed: int, packages: tuple[str, ...] = ("jax", "port")) -> dict:
    """The chain through the agent stage (``--chain-agent``): both packages'
    retrievers from their own inits (``chain``), each package's
    ``eval_retriever`` over the three splits, then the agent stage
    (``agent_stage``) three times: JAX on its store; the port on JAX's store
    from JAX's retriever and JAX's GFlowNet init (**shared**); the port on
    its own store from its own init (**own**).  JAX's own-setting run is its
    shared one: JAX's chain is deterministic on the CPU.  ``packages=("jax",)``
    runs JAX's half only."""
    from evi_rag_tpu import cli as jcli
    from evi_rag_tpu.train import checkpoint as jck
    from evi_rag_tpu_torch import cli as tcli
    from evi_rag_tpu_torch.train import checkpoint as tck

    retriever = chain(work, seed, packages=packages)
    common = chain_common(work / "normalized", seed)
    for name, main_fn, extra in (("jax", jcli.main, []), ("port", tcli.main, ["device=cpu"])):
        if name not in packages:
            continue
        assert main_fn(["eval_retriever", *common, *extra, f"retriever.ckpt={work / f'ckpt_{name}' / 'best'}",
                        "eval.splits=[train, validation, test]", f"eval.artifacts_dir={work / f'art_{name}'}",
                        f"paths.log_dir={work / f'eval_retriever_{name}'}"]) in (0, None)
    tree, meta = jck.load_checkpoint(work / "ckpt_jax" / "best")
    tck.save_checkpoint(work / "ckpt_jax_as_port", tree["params"], meta={"parity_meta": meta["parity_meta"]})
    init: dict = {}
    runs = {"jax": agent_stage(work, common, seed, "jax", "jax", work / "ckpt_jax" / "best",
                               work / "art_jax" / "g_agent", init=init)}
    if "port" not in packages:
        return {"retriever": retriever, "agent": runs}
    runs["port_shared"] = agent_stage(work, common, seed, "port", "port_shared", work / "ckpt_jax_as_port",
                                      work / "art_jax" / "g_agent", init=init)
    runs["port_own"] = agent_stage(work, common, seed, "port", "port_own", work / "ckpt_port" / "best",
                                   work / "art_port" / "g_agent")
    return {"retriever": retriever, "agent": runs}


def chain_agent_replay(work: pathlib.Path, seed: int) -> dict:
    """Step 1's harness at the chain's shapes (``--chain-agent-replay``): in
    ``work``, the JAX half of a ``--chain-agent`` run (``normalized``,
    ``ckpt_jax_as_port``, ``art_jax``, ``gfn_jax_init``, ``gfn_jax_trained``;
    made there first when ``work`` has none), the port's ``eval_gflownet``
    of JAX's initial GFlowNet and the port's shared ``train_gflownet`` +
    ``eval_gflownet``, all with JAX's draws
    (``_torch_gfn_common.replay_jax_draws``); returns both packages'
    per-epoch monitor and train loss and their evals."""
    import jax
    import jax.numpy as jnp

    from evi_rag_tpu.train import checkpoint as jck
    from evi_rag_tpu_torch import cli as tcli
    from evi_rag_tpu_torch.train import checkpoint as tck

    from _torch_gfn_common import replay_jax_draws

    from evi_rag_tpu_torch.models.gflownet import actor

    if not (work / "gfn_jax_trained").is_dir():
        chain_agent(work, seed, packages=("jax",))
    common = [*chain_common(work / "normalized", seed), "device=cpu"]
    store = work / "art_jax" / "g_agent"
    tree, meta = jck.load_checkpoint(work / "gfn_jax_init" / "ckpt" / "best")
    init = {"params": tree["params"]["gflownet"]}
    policy = jax.tree.map(jnp.asarray, init["params"]["policy"])
    graphs = 8 + 1  # experiment=webqsp_synth_hw's gflownet.batch_size and the bucket's padding graph
    out_dir = work / "replay"
    tck.save_checkpoint(out_dir / "init_port", tree["params"], meta=meta)

    def jax_run(tag):
        history = [json.loads(ln) for path in (work / f"gfn_jax_{tag}" / "train_logs").glob("**/metrics.jsonl")
                   for ln in path.read_text().splitlines()]
        (metrics,) = (work / f"gfn_jax_{tag}" / "eval_logs").glob("**/metrics.json")
        return {"history": history, "eval": json.loads(metrics.read_text())}

    def port_eval(ckpt, tag):
        with mock.patch.object(actor, "make_rollout_draws", replay_jax_draws(policy, graphs)):
            assert tcli.main(["eval_gflownet", *common, f"gflownet.ckpt={ckpt}", f"gflownet.g_agent_dir={store}",
                              "eval.splits=[validation, test]", f"eval.artifacts_dir={out_dir / tag / 'art'}",
                              f"paths.log_dir={out_dir / tag / 'eval_logs'}"]) in (0, None)
        (metrics,) = (out_dir / tag / "eval_logs").glob("**/metrics.json")
        return json.loads(metrics.read_text())

    port = {"init": {"history": [], "eval": port_eval(out_dir / "init_port", "init")}}
    with mock.patch.object(actor, "make_rollout_draws", replay_jax_draws(policy, graphs)), gflownet_init("port", init):
        assert tcli.main(["train_gflownet", *common, f"retriever.ckpt={work / 'ckpt_jax_as_port'}",
                          f"gflownet.g_agent_dir={store}", f"gflownet.seed={seed}",
                          f"gflownet.total_steps={AGENT_TOTAL_STEPS}", f"gflownet.patience={AGENT_EPOCHS}",
                          f"gflownet.max_epochs={AGENT_EPOCHS}", f"gflownet.ckpt_dir={out_dir / 'trained' / 'ckpt'}",
                          f"paths.log_dir={out_dir / 'trained' / 'train_logs'}"]) in (0, None)
    history = [json.loads(ln) for path in (out_dir / "trained" / "train_logs").glob("**/metrics.jsonl")
               for ln in path.read_text().splitlines()]
    port["trained"] = {"history": history, "eval": port_eval(out_dir / "trained" / "ckpt" / "best", "trained")}
    result = {"jax": {tag: jax_run(tag) for tag in ("init", "trained")}, "port_replay": port}
    for tag in ("init", "trained"):
        jh, ph = result["jax"][tag]["history"], port[tag]["history"]
        for epoch, (a, b) in enumerate(zip(jh, ph)):
            print(json.dumps({"seed": seed, "epoch": epoch, "jax": {k: a.get(k) for k in ("answer_hit", "train_loss")},
                              "port": {k: b.get(k) for k in ("answer_hit", "train_loss")}}))
        je, pe = result["jax"][tag]["eval"], port[tag]["eval"]
        print(json.dumps({"seed": seed, "params": tag, **{k: (je.get(k), pe.get(k)) for k in sorted(je)
                                                          if "answer_hit" in k and "_ref" not in k}}))
    return result


def chain_agent_main(out_path: pathlib.Path, seed: int) -> None:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        result = chain_agent(pathlib.Path(tmp), seed)
    for run, stages in result["agent"].items():
        trained = stages["trained"]
        per_epoch = len(trained["steps"]) // max(len(trained["history"]), 1)
        for epoch, row in enumerate(trained["history"]):
            loss, bc = trained["steps"][(epoch + 1) * per_epoch - 1]
            print(json.dumps({"run": run, "epoch": epoch, "answer_hit": row.get("answer_hit"),
                              **{f"answer_hit@{k}": row.get(f"answer_hit@{k}") for k in AGENT_KS},
                              "bc_weight": bc, "train_loss": row.get("train_loss"), "last_step_loss": loss}))
        for label, stage in stages.items():
            ev = stage["eval"]
            print(json.dumps({"run": run, "params": label, **{f"{s}/answer_hit@{k}": ev.get(f"{s}/answer_hit@{k}")
                                                              for s in ("validation", "test") for k in AGENT_KS},
                              "validation/answer_hit": ev.get("validation/answer_hit")}))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"seed": seed, **result}, indent=1))


def chain_main(out_path: pathlib.Path, seed: int, *, init: str = "own", dtype: str = "bfloat16") -> None:
    import tempfile

    keys = ("answer/reachability@100", "edge/recall@10", "edge/recall@100", "bridge/recall@10")
    with tempfile.TemporaryDirectory() as tmp:
        runs = chain(pathlib.Path(tmp), seed, init=init, dtype=dtype)
    for name, history in runs.items():
        for epoch, row in enumerate(history):
            print(json.dumps({"package": name, "epoch": epoch, **{k: row.get(k) for k in keys},
                              "train_loss": row.get("train_loss")}))
    for name, history in runs.items():
        print(f"{name}: best answer/reachability@100 {max(r['answer/reachability@100'] for r in history):.4f}, "
              f"last edge/recall@100 {history[-1]['edge/recall@100']:.4f}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps({"seed": seed, "init": init, "dtype": dtype, "runs": runs}, indent=1))


def chain_agent_summary(paths: list[str]) -> dict:
    """The rule of ``PERF.md`` §6 (PR 13) over ``--chain-agent`` outputs of
    several seeds: per seed, each run's final validation answer_hit@25 (the
    kept checkpoint) and its untrained floor, and port - JAX in the shared
    and own settings; the mean over the seeds and the largest gap in
    questions of 64."""
    key = "validation/answer_hit@25"
    rows, gaps = [], {"port_shared": [], "port_own": []}
    for path in paths:
        res = json.loads(pathlib.Path(path).read_text())
        agent = res["agent"]
        final = {run: agent[run]["trained"]["eval"][key] for run in agent}
        floor = {run: agent[run]["init"]["eval"][key] for run in agent}
        for run in gaps:
            gaps[run].append(final[run] - final["jax"])
        rows.append({"seed": res["seed"], "final": final, "floor": floor,
                     "monitor": {run: [h.get("answer_hit") for h in agent[run]["trained"]["history"]] for run in agent}})
        print(json.dumps(rows[-1]))
    n = CHAIN_COUNTS["validation"]
    summary = {run: {"mean": sum(g) / len(g), "max_questions": max(abs(x) for x in g) * n} for run, g in gaps.items()}
    summary["rule_holds"] = (abs(summary["port_shared"]["mean"]) <= 0.02
                             and summary["port_shared"]["max_questions"] <= 3 + 1e-9)
    print(json.dumps(summary))
    return summary


def main() -> None:
    from evi_rag_tpu_torch.scripts import benchmark_quality as port

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default=str(REPO / "artifacts" / "quality" / "seed_spread.json"))
    ap.add_argument("--chain", action="store_true", help="the chain's retriever, both packages (see the docstring)")
    ap.add_argument("--chain-seed", type=int, default=0, help="retriever.train.seed of both --chain runs")
    ap.add_argument("--chain-init", choices=("own", "shared", "port"), default="own",
                    help="each package's own init, JAX's init for both, or the port's init for both (--chain)")
    ap.add_argument("--chain-dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="retriever.model.compute_dtype of both --chain runs")
    ap.add_argument("--chain-agent", action="store_true",
                    help="with --chain: on through eval_retriever, train_gflownet and eval_gflownet (see the docstring)")
    ap.add_argument("--chain-agent-replay", metavar="WORK",
                    help="the port's agent stage on a kept --chain-agent work dir with JAX's draws (see the docstring)")
    ap.add_argument("--chain-agent-summary", nargs="+", metavar="JSON",
                    help="the agent-stage rule over --chain-agent outputs of several seeds")
    args = ap.parse_args()
    if args.chain_agent_summary:
        chain_agent_summary(args.chain_agent_summary)
        return
    if args.chain_agent_replay:
        result = chain_agent_replay(pathlib.Path(args.chain_agent_replay), args.chain_seed)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
        return
    if args.chain and args.chain_agent:
        chain_agent_main(pathlib.Path(args.out), args.chain_seed)
        return
    if args.chain:
        chain_main(pathlib.Path(args.out), args.chain_seed, init=args.chain_init, dtype=args.chain_dtype)
        return
    scratch = pathlib.Path(args.out).parent
    scratch.mkdir(parents=True, exist_ok=True)
    grids: dict[str, dict[int, dict]] = {"jax": {}, "port": {}}
    for seed in args.seeds:
        jr = jax_quality(["--out", str(scratch / f"jax_seed{seed}.md")], seed=seed)
        grids["jax"][seed] = port.metric_grid(jr)
        with contextlib.redirect_stdout(io.StringIO()):
            pr = port.main(["--device", "cpu", "--seed", str(seed), "--out", str(scratch / f"port_seed{seed}.md")])
        grids["port"][seed] = port.metric_grid(pr)
        print(json.dumps({"seed": seed, **{p: {m: grids[p][seed][m] for m in BAR_METRICS} for p in grids}}),
              flush=True)
    spreads = {p: spread(list(grids[p].values())) for p in grids}
    limits = bar(spreads["jax"])
    inside = {m: all(limits[m][0] <= g[m] <= limits[m][1] for g in grids["port"].values()) for m in BAR_METRICS}
    for m in BAR_METRICS:
        print(f"{m}: jax min/max {spreads['jax'][m][0]:.4f}/{spreads['jax'][m][1]:.4f}  port min/max "
              f"{spreads['port'][m][0]:.4f}/{spreads['port'][m][1]:.4f}  bar [{limits[m][0]:.4f}, "
              f"{limits[m][1]:.4f}]  port inside: {inside[m]}")
    pathlib.Path(args.out).write_text(json.dumps({"grids": grids, "spread": spreads, "bar": limits,
                                                  "port_inside": inside}, indent=1))
    print(json.dumps({"bar": limits, "port_inside": inside}))


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()

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
each package's per-epoch validation metrics.
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


def chain(work: pathlib.Path, seed: int) -> dict:
    """Both packages' ``train_retriever`` under ``experiment=webqsp_synth_hw``
    on one JAX-built dataset, each with ``retriever.train.seed=seed``;
    returns {package: per-epoch metrics}."""
    import subprocess

    from evi_rag_tpu import cli as jcli
    from evi_rag_tpu_torch import cli as tcli

    raw, root = work / "raw", work / "normalized"
    subprocess.run([sys.executable, str(REPO / "scripts" / "make_synthetic_webqsp.py"), "--out", str(raw), "--seed",
                    "0", *(f"--{k}={v}" for k, v in CHAIN_COUNTS.items())], check=True)
    configs = str(REPO / "configs")
    assert jcli.main(["build", "--configs-dir", configs, "build.dataset=webqsp_synth", f"build.raw_root={raw}",
                      f"build.out_dir={root}", "build.encoder.dim=64", f"paths.log_dir={work / 'logs'}"]) in (0, None)
    warmup, total = CHAIN_SCHEDULE
    common = ["--configs-dir", configs, "experiment=webqsp_synth_hw", "dataset=webqsp_synth-sub",
              f"dataset.normalized_dir={root}", "retriever.model.hidden_dim=64", "retriever.train.max_epochs=8",
              "retriever.train.patience=8", f"retriever.train.optimizer.warmup_steps={warmup}",
              f"retriever.train.optimizer.total_steps={total}", f"retriever.train.seed={seed}",
              "extras.print_config=false"]
    out = {}
    for name, main_fn, extra in (("jax", jcli.main, []), ("port", tcli.main, ["device=cpu"])):
        logs = work / f"logs_{name}"
        assert main_fn(["train_retriever", *common, *extra, f"retriever.train.ckpt_dir={work / f'ckpt_{name}'}",
                        f"paths.log_dir={logs}"]) in (0, None)
        (history,) = logs.glob("**/metrics.jsonl")
        out[name] = [json.loads(ln) for ln in history.read_text().splitlines()]
    return out


def chain_main(out_path: pathlib.Path, seed: int) -> None:
    import tempfile

    keys = ("answer/reachability@100", "edge/recall@10", "edge/recall@100", "bridge/recall@10")
    with tempfile.TemporaryDirectory() as tmp:
        runs = chain(pathlib.Path(tmp), seed)
    for name, history in runs.items():
        for epoch, row in enumerate(history):
            print(json.dumps({"package": name, "epoch": epoch, **{k: row.get(k) for k in keys},
                              "train_loss": row.get("train_loss")}))
    for name, history in runs.items():
        print(f"{name}: best answer/reachability@100 {max(r['answer/reachability@100'] for r in history):.4f}, "
              f"last edge/recall@100 {history[-1]['edge/recall@100']:.4f}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(runs, indent=1))


def main() -> None:
    from evi_rag_tpu_torch.scripts import benchmark_quality as port

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", default=str(REPO / "artifacts" / "quality" / "seed_spread.json"))
    ap.add_argument("--chain", action="store_true", help="the chain's retriever, both packages (see the docstring)")
    ap.add_argument("--chain-seed", type=int, default=0, help="retriever.train.seed of both --chain runs")
    args = ap.parse_args()
    if args.chain:
        chain_main(pathlib.Path(args.out), args.chain_seed)
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

"""The port's pipeline drivers (``evi_rag_tpu_torch/scripts/*.sh``) end to
end on the CPU, as ``tests/test_shell_pipeline.py`` drives the JAX ones.

The full pipeline runs on the same toy real-format parquet (build -> train
-> dual eval -> gflownet -> rollouts -> oracle) in an isolated working
directory, with the JAX test's small settings patched into the script and
``device=cpu`` given to every stage; the ablation driver runs a 1 x 1 grid
on synthetic data.
"""

import json
import os
import pathlib
import shutil
import subprocess

from test_shell_pipeline import _gen_raw

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "evi_rag_tpu_torch" / "scripts"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_run_full_pipeline_script(tmp_path):
    work = tmp_path / "work"
    (work / "data" / "raw" / "toy").mkdir(parents=True)
    shutil.copytree(REPO / "configs", work / "configs")
    for split, n, seed in (("train", 12, 0), ("validation", 6, 1), ("test", 6, 2)):
        _gen_raw(work / "data" / "raw" / "toy", split, n, seed)

    script = (SCRIPTS / "run_full_pipeline.sh").read_text()
    assert 'CLI="python -m evi_rag_tpu_torch.cli"' in script
    for old, new in (
        ('retriever.train.ckpt_dir="$ART/ckpt/retriever"',
         'retriever.train.ckpt_dir="$ART/ckpt/retriever" retriever.model.emb_dim=auto '
         "retriever.model.hidden_dim=auto retriever.train.max_epochs=1 build.encoder.dim=32"),
        ('build.out_dir="data/normalized/$DATASET"',
         'build.out_dir="data/normalized/$DATASET" build.encoder.dim=32 build.text_policy.mode=all'),
        ('"eval.splits=[train, validation, test]"',
         'retriever.model.emb_dim=auto retriever.model.hidden_dim=auto '
         '"eval.splits=[train, validation, test]" eval.g_agent.edge_top_k=30'),
        ('gflownet.ckpt_dir="$ART/ckpt/gflownet"',
         'gflownet.ckpt_dir="$ART/ckpt/gflownet" gflownet.hidden_dim=auto gflownet.max_epochs=1 '
         "gflownet.num_train_rollouts=2 retriever.model.emb_dim=auto retriever.model.hidden_dim=auto"),
        ('gflownet.g_agent_dir="$ART/$DATASET-sub/g_agent" \\\n  eval.artifacts_dir="$ART/$DATASET-sub" "$@"\n\necho "== [6/6]',
         'gflownet.g_agent_dir="$ART/$DATASET-sub/g_agent" gflownet.hidden_dim=auto '
         'gflownet.eval_rollouts=4 "gflownet.eval_rollout_prefixes=[1, 4]" "eval.splits=[validation]" '
         '\\\n  eval.artifacts_dir="$ART/$DATASET-sub" "$@"\n\necho "== [6/6]'),
    ):
        assert script.count(old) == 1, old
        script = script.replace(old, new)
    (work / "run.sh").write_text(script)

    proc = subprocess.run(
        ["bash", "run.sh", "toy", "artifacts/toy", "device=cpu", "extras.print_config=false"], cwd=work,
        env=_env(), capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout[-4000:]}\nstderr:\n{proc.stderr[-4000:]}"
    assert "pipeline complete" in proc.stdout
    for n in range(1, 7):
        assert f"== [{n}/6]" in proc.stdout

    art = work / "artifacts" / "toy"
    assert (art / "ckpt" / "retriever" / "best" / "meta.json").exists()
    assert (art / "ckpt" / "gflownet" / "best" / "meta.json").exists()
    assert (art / "toy-sub" / "g_agent" / "train" / "manifest.json").exists()
    assert (art / "toy" / "g_agent" / "test" / "manifest.json").exists()
    assert (art / "toy-sub" / "eval_gflownet" / "validation.jsonl").exists()
    metrics_files = sorted((work / "logs").rglob("metrics.json"), key=lambda p: p.stat().st_mtime)
    assert metrics_files, "no metrics.json produced"
    last = json.loads(metrics_files[-1].read_text())
    assert last, "empty metrics"


def test_mask_ablation_script_single_point(tmp_path):
    """The port's ablation driver runs the hide-and-seek grid as shipped; a
    1 x 1 env-driven grid on synthetic data is the smoke path."""
    env = _env()
    env.update(ABLATION_P_NEAR="0.3", ABLATION_BIAS_NEAR="-2.0")
    work = tmp_path / "work"
    work.mkdir()
    shutil.copytree(REPO / "configs", work / "configs")
    proc = subprocess.run(
        ["bash", str(SCRIPTS / "run_retriever_mask_ablation.sh"),
         "synthetic", "experiment=quick_synthetic", "extras.print_config=false", "device=cpu",
         f"paths.log_dir={work}/logs", f"retriever.train.ckpt_dir={work}/ckpt"],
        cwd=work, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
    assert "ablation p_near=0.3 bias_near=-2.0" in proc.stdout
    assert (work / "ckpt" / "best" / "meta.json").exists()

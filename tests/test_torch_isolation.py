"""The port stands alone and runs on the GPU unless told otherwise.

* No file of ``evi_rag_tpu_torch/`` (its ``scripts/`` too) and not
  ``chip_smoke.py`` imports JAX, flax, optax, orbax, anything of
  ``evi_rag_tpu``, or the JAX package's root ``bench.py`` and ``scripts/``
  (an AST scan, so lazy imports inside functions and ``import_module``
  calls count too); the port's shell drivers call the port's CLI and never
  the JAX one.
* ``pyarrow``, ``transformers``, ``safetensors``, ``tiktoken``, ``openai``
  and ``vllm`` (absent on the card's machine, or optional backends) are
  imported only inside the functions that need them.
* The default device is CUDA: with no GPU and no explicit CPU request the
  entry points raise instead of running on the CPU.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# The root ``bench`` and ``scripts`` modules are the JAX package's tools:
# the port keeps its own (``evi_rag_tpu_torch.bench``, ``evi_rag_tpu_torch.scripts``).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "evi_rag_tpu", "bench", "scripts")
LAZY = ("pyarrow", "transformers", "safetensors", "tiktoken", "openai", "vllm")


def _port_files():
    files = sorted((ROOT / "evi_rag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_scan_covers_the_port_scripts():
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert {"evi_rag_tpu_torch/scripts/__init__.py", "evi_rag_tpu_torch/scripts/benchmark_quality.py",
            "evi_rag_tpu_torch/scripts/quality_gate.py", "evi_rag_tpu_torch/scripts/profile_gfn_step.py",
            "evi_rag_tpu_torch/scripts/measure_fused_crossover.py", "evi_rag_tpu_torch/bench.py"} <= scanned


@pytest.mark.parametrize("name", ["run_full_pipeline.sh", "run_retriever_mask_ablation.sh"])
def test_port_shell_drivers_call_the_port_cli(name):
    text = (ROOT / "evi_rag_tpu_torch" / "scripts" / name).read_text()
    assert 'CLI="python -m evi_rag_tpu_torch.cli"' in text
    assert "evi_rag_tpu.cli" not in text and "import jax" not in text


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and (getattr(node.func, "id", None) == "__import__"
                                             or getattr(node.func, "attr", None) == "import_module"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_optional_packages_are_imported_lazily(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    top = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            top += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            top.append(node.module)
    bad = [m for m in top if m.split(".")[0] in LAZY]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


def test_resolve_device_defaults_to_cuda(monkeypatch):
    from evi_rag_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.serving import project_tables, serve_split

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_synthetic_dataset(num_samples=2, emb_dim=8, max_nodes=8, seed=0)
    bundle = {"features": {}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        project_tables(bundle, ds.entity_emb, ds.relation_emb)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_split(bundle, ds.samples, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                    question_emb=ds.question_emb, k=4, num_rounds=2, num_reverse_rounds=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.task_serve.__wrapped__({"retriever": {"ckpt": str(tmp_path)}}, run_dir=tmp_path)
    # build resolves the device before its encoder, whatever the encoder.
    for kind in ("hash", "gte_jax"):
        build = {"dataset": "toy", "raw_root": str(tmp_path), "out_dir": str(tmp_path / "out"),
                 "encoder": {"kind": kind, "model_path": str(tmp_path)}}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.task_build.__wrapped__({"build": build}, run_dir=tmp_path)
    assert not (tmp_path / "out").exists()
    assert np.isfinite(ds.entity_emb).all()


def test_build_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """The gte model and encoder and the HF encoder run on the card unless
    the CPU is named; ``seed_stats`` is host only."""
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data.gte import GTEConfig, GTEModel, GTETextEncoder
    from evi_rag_tpu_torch.data.text_encoder import TorchHFTextEncoder
    from evi_rag_tpu_torch.testing import random_gte_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GTEConfig(vocab_size=16, hidden_size=8, num_hidden_layers=1, num_attention_heads=2, intermediate_size=8)
    state = random_gte_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GTEModel.from_state_dict(state, cfg)
    assert GTEModel.from_state_dict(state, cfg, device="cpu").cfg == cfg
    for make in (GTETextEncoder, TorchHFTextEncoder):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(str(tmp_path))
    run = tmp_path / "stats"
    run.mkdir()
    m = cli.task_seed_stats.__wrapped__({"dataset": {"num_samples": 4, "emb_dim": 8}, "eval": {"splits": ["train"]}},
                                        run_dir=run)
    assert m["train/onehop_edges/mean"] > 0


def test_pooled_entry_points_raise_without_gpu(monkeypatch):
    from evi_rag_tpu_torch.ops.query import TripleIndex, build_triple_index, query_topk, score_all

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = TripleIndex(*(torch.zeros(4, n) for n in (8, 8, 8, 2)))
    q = np.zeros((1, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_triple_index({"features": {}}, entity_emb=np.zeros((3, 8), np.float32),
                           relation_emb=np.zeros((2, 8), np.float32), nontext_mask=np.zeros(3, bool),
                           heads=np.zeros(4, np.int32), rels=np.zeros(4, np.int32),
                           tails=np.zeros(4, np.int32), struct_raw=np.zeros((4, 2), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        query_topk({"features": {}}, q, index, k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_all({"features": {}}, q, index)


def test_training_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """``train_retriever``, ``fit``, ``create_train_state`` and
    ``make_tables`` run on the card unless the CPU is named."""
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.models.retriever import Retriever
    from evi_rag_tpu_torch.train.retriever_trainer import RetrieverTrainConfig, create_train_state, fit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ent, rel = np.zeros((3, 8), np.float32), np.zeros((2, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tables(ent, rel)
    assert make_tables(ent, rel, device="cpu").entity.shape == (4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.task_train_retriever.__wrapped__({}, run_dir=tmp_path)
    model = Retriever(emb_dim=8, hidden_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(model, RetrieverTrainConfig(), lambda epoch: iter([None]), lambda: iter(()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(model, None, RetrieverTrainConfig())
    # Data-parallel training runs one process per device: the default mesh
    # needs a card, and a two-entry mesh in one process names the launch.
    from evi_rag_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        fit(model, RetrieverTrainConfig(), lambda epoch: iter([None]), lambda: iter(()),
            mesh=make_mesh(devices=["cpu"] * 2), device="cpu")


def test_gflownet_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    """``eval_retriever``, ``train_gflownet``, ``eval_gflownet``,
    ``fit_gflownet`` and ``init_gflownet_params`` run on the card unless
    the CPU is named."""
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.train.gflownet_trainer import GFlowNetConfig, build_modules, fit_gflownet, init_gflownet_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for task in (cli.task_eval_retriever, cli.task_train_gflownet, cli.task_eval_gflownet):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            task.__wrapped__({}, run_dir=tmp_path)
    cfg = GFlowNetConfig(hidden_dim=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_gflownet(cfg, {"features": {}, "parity_meta": {}}, lambda epoch: iter([None]), lambda: iter(()))
    modules = build_modules(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_gflownet_params(cfg, modules)
    assert init_gflownet_params(cfg, modules, device="cpu")["policy"]["params"]["attn_q"]["kernel"].shape == (8, 8)


def test_quality_entry_points_raise_without_gpu(monkeypatch):
    """The quality gate and the quality baseline run on the card unless the
    CPU is named."""
    from evi_rag_tpu_torch.scripts import benchmark_quality, quality_gate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_gate.quality_gate()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark_quality.run(samples=16, epochs=1)


def test_bench_entry_points_raise_without_gpu(monkeypatch):
    """The port's bench, its sections, the GFlowNet profiler and the
    crossover sweep run on the card unless the CPU is named."""
    from evi_rag_tpu_torch import bench
    from evi_rag_tpu_torch.scripts import measure_fused_crossover, profile_gfn_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bundle = bench.make_bundle(8, 8, 4)
    calls = {
        "run_cli": lambda: bench.run_cli([]),
        "main": lambda: bench.main({}),
        "build_inputs_device": lambda: bench.build_inputs_device(4, 8, 4, 2),
        "bench_query": lambda: bench.bench_query(bundle, bench.build_inputs(4, 8, 4, 2), k=2, chunk=4),
        "bench_index_build": lambda: bench.bench_index_build(8, 4, 2, 4),
        "bench_knn": lambda: bench.bench_knn(8, 4, 2, 2),
        "bench_train_step": lambda: bench.bench_train_step(samples=2, dim=8),
        "bench_gflownet_step": lambda: bench.bench_gflownet_step(graphs=2, dim=8),
        "bench_gflownet_step_wide": lambda: bench.bench_gflownet_step_wide(2, dim=8),
        "bench_serve_surface": lambda: bench.bench_serve_surface(2, 8, 2),
        "profile_gfn_step._build": lambda: profile_gfn_step._build(2, emb=8),
        "profile_gfn_step.main": lambda: profile_gfn_step.main([]),
        "measure_fused_crossover.main": lambda: measure_fused_crossover.main(dim=8, widths=(8,)),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
            pytest.fail(name)


@pytest.mark.parametrize("knob", ["sample_then_score", "remat_dots", "stacked"])
def test_unported_gflownet_knobs_raise(knob):
    """None of these knobs raises any more.  The two-pass rollout and the
    'dots' remat policy are ported: their configs build
    (``tests/test_torch_gflownet_sts.py`` holds them to JAX).  A stacked
    (data-parallel) agent batch runs shard by shard: its loss is the mean of
    the shards' flat losses under the same draws
    (``tests/test_torch_dp_train.py`` holds the step to JAX's)."""
    import dataclasses

    from evi_rag_tpu_torch.testing import agent_inputs, random_bundle
    from evi_rag_tpu_torch.train.gflownet_trainer import (
        GFlowNetConfig, GFlowNetModules, build_modules, bundle_on, init_gflownet_params, rollout_losses,
        train_rollout_draws)

    cfg = GFlowNetConfig(hidden_dim=8)
    if knob == "stacked":
        cfg = dataclasses.replace(cfg, max_steps=2, num_train_rollouts=2, dropout=0.0)
        modules = build_modules(cfg)
        init_gflownet_params(cfg, modules, seed=0, device="cpu")
        batch = agent_inputs(8, 4, seed=0, shards=2)
        gen = torch.Generator().manual_seed(0)
        draws = [train_rollout_draws(cfg, batch.shard(i), gen) for i in range(2)]
        kw = dict(num_rollouts=2, bc_weight=0.5, temperature=1.0, train=True)
        bundle = bundle_on(random_bundle(8), torch.device("cpu"))
        loss, metrics = rollout_losses(modules, bundle, batch, cfg, draws=draws, **kw)
        flat = [rollout_losses(modules, bundle, batch.shard(i), cfg, draws=draws[i], **kw) for i in range(2)]
        assert torch.equal(loss, (flat[0][0] + flat[1][0]) / 2)
        assert metrics["answer_hit_graphs"].shape[0] == 2 and metrics["answer_hit"].ndim == 0
        return
    cfg = dataclasses.replace(cfg, **({"sample_then_score": True} if knob == "sample_then_score"
                                      else {"remat_policy": "dots"}))
    assert isinstance(build_modules(cfg), GFlowNetModules)
    assert cfg.actor.sample_then_score or cfg.actor.remat_policy == "dots"

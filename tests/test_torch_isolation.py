"""The port stands alone and runs on the GPU unless told otherwise.

* No file of ``evi_rag_tpu_torch/`` and not ``chip_smoke.py`` imports JAX,
  flax, orbax or anything of ``evi_rag_tpu`` (an AST scan, so lazy imports
  inside functions count too).
* The default device is CUDA: with no GPU and no explicit CPU request the
  entry points raise instead of running on the CPU.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "evi_rag_tpu")


def _port_files():
    files = sorted((ROOT / "evi_rag_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


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
    assert np.isfinite(ds.entity_emb).all()


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

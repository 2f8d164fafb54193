"""The port's multi-process glue (``parallel/multihost.py``) against JAX's.

* ``initialize_distributed`` is a no-op without the ``EVI_*`` variables
  (``tests/test_multihost.py::test_initialize_noop_without_coordination``)
  or with only ``torchrun``'s, starts a group from ``env://`` under
  ``EVI_DISTRIBUTED=1`` as JAX's one switch, and lets a
  misconfigured launch fail: a bad address, nobody to join, a missing
  process id.
* ``gather_records`` dedups last-wins as JAX's does on one process
  (``tests/test_sharded.py:119-135``), and merges across two gloo ranks as
  JAX's two-process test expects (``tests/test_multihost.py:31-86``: ids
  ``[0, 1, 2]`` on every rank).
* ``main_process_only`` runs on rank 0 only; ``serve`` and the eval tasks'
  check raise the single-process-eval ``ConfigError`` under two ranks.
* The backend: gloo on the CPU, nccl when every local rank has a card,
  gloo when ranks share one.

Every process-group test takes its port from ``socket.bind`` and a time
limit; the two-rank ones run in subprocesses (``testing_dp``) with
one thread each.
"""

import pytest
import torch
import torch.distributed as dist

from evi_rag_tpu.parallel import multihost as jmh
from evi_rag_tpu_torch.parallel import multihost as tmh
from evi_rag_tpu_torch.testing_dp import free_port, spawn_checks

ENV = ("EVI_COORDINATOR_ADDRESS", "EVI_NUM_PROCESSES", "EVI_PROCESS_ID", "EVI_DISTRIBUTED")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_noop_without_coordination(clean_env):
    assert tmh.initialize_distributed() is None
    assert not dist.is_initialized() and tmh.world_size() == 1 and tmh.is_main_process()


def test_initialize_from_torchrun_env(clean_env):
    for name, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(free_port())), ("WORLD_SIZE", "1"),
                        ("RANK", "0"), ("LOCAL_RANK", "0"), ("LOCAL_WORLD_SIZE", "1")):
        clean_env.setenv(name, value)
    assert tmh.initialize_distributed() is None  # torchrun's variables alone: JAX's one switch decides
    clean_env.setenv("EVI_DISTRIBUTED", "1")
    try:
        assert tmh.initialize_distributed(timeout_s=30) == "gloo"
        assert dist.is_initialized() and tmh.world_size() == 1
        assert tmh.initialize_distributed() == "gloo"  # idempotent
    finally:
        dist.destroy_process_group()
    clean_env.setenv("EVI_DISTRIBUTED", "0")
    assert tmh.initialize_distributed() is None


@pytest.mark.parametrize("case", ["bad_port", "nobody_to_join", "no_process_id"])
def test_misconfigured_launch_fails(clean_env, case):
    if case == "bad_port":
        with pytest.raises(ValueError):
            tmh.initialize_distributed("127.0.0.1:notaport", 2, 0, timeout_s=1)
    elif case == "nobody_to_join":
        with pytest.raises(Exception, match="timed out|connect"):
            tmh.initialize_distributed(f"127.0.0.1:{free_port()}", 2, 1, timeout_s=1)
    else:
        clean_env.setenv("EVI_COORDINATOR_ADDRESS", f"127.0.0.1:{free_port()}")
        clean_env.setenv("EVI_NUM_PROCESSES", "2")
        with pytest.raises(ValueError, match="EVI_PROCESS_ID"):
            tmh.initialize_distributed()
    assert not dist.is_initialized()


def test_gather_records_single_process_matches_jax():
    recs = [{"id": 1, "v": "a"}, {"id": 2, "v": "b"}, {"id": 1, "v": "c"}]
    key = lambda r: r["id"]  # noqa: E731
    assert tmh.gather_records(recs, dedup_key=key) == jmh.gather_records(recs, dedup_key=key)
    assert {r["id"]: r["v"] for r in tmh.gather_records(recs, dedup_key=key)} == {1: "c", 2: "b"}
    assert tmh.gather_records(recs) == jmh.gather_records(recs) == recs

    calls = []

    @tmh.main_process_only
    def write():
        calls.append(1)
        return "done"

    assert write() == "done" and calls == [1]


def test_choose_backend(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmh.choose_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmh.choose_backend(4) == "nccl"
    assert tmh.choose_backend(8) == "gloo"  # two ranks on a card: NCCL refuses them


def test_two_ranks_gather_guard_and_single_process_eval(tmp_path):
    rows = spawn_checks({"device": "cpu", "out_dir": str(tmp_path), "timeout_s": 60,
                         "checks": [{"kind": "glue", "name": "glue"}]}, 2, timeout_s=120, threads=1)
    for r, row in enumerate(rows):
        assert row["rank"] == r and row["world"] == 2 and row["backend"] == "gloo"
        g = row["checks"]["glue"]
        # The merged records are identical everywhere: dedup'd id 0 (rank 1's
        # record wins) plus both ranks' own ids.
        assert [x["id"] for x in g["merged"]] == [0, 1, 2]
        assert g["merged"][0]["rank"] == 1
        assert g["main_only"] == (0 if r == 0 else None)
        assert "single process" in g["errors"]["serve"] and "single process" in g["errors"]["eval"]
        assert g["errors"]["eval_allowed"] is None


def test_mesh_placement():
    """``make_mesh`` names the CPU only on request and may repeat a device;
    ``shard_batch`` splits every leading axis over the entries (raising on
    an uneven one); ``place_replicated`` / ``per_device`` make one copy per
    distinct device, shared by the entries that repeat it."""
    from evi_rag_tpu_torch.parallel.mesh import make_mesh, per_device, place_replicated, shard_batch

    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="requested 5 devices"):
        make_mesh(5, devices=["cpu"] * 4)
    blocks = shard_batch({"x": torch.arange(8), "y": torch.zeros(4, 3)}, mesh)
    assert [b["x"].tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]] and blocks[3]["y"].shape == (1, 3)
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(torch.zeros(6), mesh)
    tree = {"w": {"kernel": torch.ones(2, 2)}}
    copies = place_replicated(tree, mesh)
    assert len(copies) == 4 and all(c is copies[0] for c in copies) and torch.equal(copies[0]["w"]["kernel"], tree["w"]["kernel"])
    made = []
    assert per_device(make_mesh(devices=["cpu", "cpu"]), lambda d: made.append(d) or len(made)) == [1, 1]

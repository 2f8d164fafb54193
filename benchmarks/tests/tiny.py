"""Tiny cells for the CPU tests: the real drivers, configurations cut to
D = H = 64 and small graphs."""

from __future__ import annotations

import copy

from benchmarks import harness


# Each kind's traffic at a tiny size.
TINY = {"serve": dict(request=32, check_answers=12),
        "pooled": dict(queries=8, check_queries=4),
        "train": dict(batch=4)}
# Serve graphs wide enough that a request of 32 in the engine's groups of 16
# fills a group from m_pad 256 up, which takes kernel 3.
SERVE_GRAPH = dict(lognorm_mean=4.6, edge_max=600)


def cell(workload: str) -> dict:
    c = harness.cell(harness.load_spec(), workload)
    cfg = copy.deepcopy(c["config"])
    cfg["model"].update(emb_dim=64, hidden_dim=64, k=16)
    cfg["graph"].update(entities=3000, relations=40, lognorm_mean=3.6, edge_min=12, edge_max=300)
    cfg["splits"] = {"train": 48, "validation": 8, "test": 40}
    cfg["index_triples"] = 1024
    if c["traffic"]["kind"] == "serve":
        cfg["graph"].update(SERVE_GRAPH)
    return dict(c, config=cfg, traffic=dict(c["traffic"], **TINY[c["traffic"]["kind"]]))

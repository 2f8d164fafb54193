"""Serve driver: one closed-loop client sends requests of distinct questions
of one split to ``serving.serve_split`` (the engine of ``cli serve``), each
waited for until its top-k is on the host, the next sent at once.

The engine's own choices (the group size and the edge width from which a
group takes kernel 3) are the program's: ``engine_options`` reads them as
``cli serve`` does, so a change to them shows in the cell.

Traffic keys: ``split`` (the configuration's split whose size is the
question count), ``request`` (questions a request), ``edge_min`` /
``edge_max`` / ``edge_rule`` (``clip`` the log-normal to the range, as the
presets do, or ``truncate`` it to the range), ``check_answers`` (answers the
comparison samples).
"""

from __future__ import annotations

import inspect
import time

import numpy as np
import torch

from benchmarks import gen, harness
from benchmarks.drivers import common
from benchmarks.reference import compare, model as ref


def engine_options() -> dict[str, int]:
    """``group_size`` and ``fused_threshold`` as ``cli serve`` hands them to
    ``serve_split``: the program's serve configuration (``configs/serve.yaml``)
    where it names them, else ``serve_split``'s own defaults."""
    from evi_rag_tpu_torch.serving import serve_split
    from evi_rag_tpu_torch.utils.config import load_config

    sv = load_config(harness.ROOT / "configs", "serve").get("serve", {})
    defaults = inspect.signature(serve_split).parameters
    return {key: int(sv.get(key, defaults[key].default)) for key in ("group_size", "fused_threshold")}


def setup(cell: dict, seed: int, device: torch.device, spans) -> dict:
    from evi_rag_tpu_torch.serving import project_tables

    cfg, tr = cell["config"], cell["traffic"]
    g = cfg["graph"]
    d, h, s, k = common.model_dims(cfg)
    n = int(cfg["splits"][tr["split"]])
    with spans("setup.graphs"):
        qs = gen.split(seed, n, g, edge_min=tr.get("edge_min"), edge_max=tr.get("edge_max"),
                       rule=tr.get("edge_rule", "clip"))
        nontext = gen.nontext_flags(seed, g)
        samples = common.samples(qs, nontext, tr["split"])
    with spans("setup.tables"):
        ent, rel, qtab = gen.tables(seed, g, d, n, device)
        P = gen.weights(seed, d, h, s, device)
        host = [x.cpu().numpy() for x in (ent, rel, qtab)]
    bundle = {"features": P}
    with spans("setup.project"):
        projected = project_tables(bundle, host[0], host[1], device=device)
    st = dict(cell=cell, seed=seed, device=device, qs=qs, samples=samples, tables=(ent, rel, qtab), host=host,
              P=P, bundle=bundle, projected=projected, k=k, engine=engine_options(),
              requests=common.request_stream(seed, n, int(tr["request"]), 0))
    with spans("setup.warmup"):  # every bucket of the split once, in requests of the cell's size
        order = np.argsort([q["edge_index"].shape[1] for q in qs])
        size = int(tr["request"])
        for i in range(0, n, size):
            _serve(st, order[i:i + size])
    return st


def _serve(st: dict, idx):
    from evi_rag_tpu_torch.serving import serve_split

    m = st["cell"]["config"]["model"]
    ent, rel, q = st["host"]
    return serve_split(
        st["bundle"], [st["samples"][i] for i in idx], entity_emb=ent, relation_emb=rel, question_emb=q,
        k=st["k"], num_rounds=int(m["dde_rounds"]), num_reverse_rounds=int(m["dde_reverse_rounds"]),
        projected=st["projected"], device=st["device"], **st["engine"])


def window(st: dict, seconds: float, spans) -> dict:
    served, lat, stats, failed = [], [], [], 0
    t0 = time.perf_counter()
    while True:
        idx = next(st["requests"])
        a = time.perf_counter()
        with spans("request"):
            res, stat = _serve(st, idx)
        b = time.perf_counter()
        lat.append(b - a)
        got = {r.sample_id: (r.edge_ids, r.scores) for r in res}
        answers = [got.get(st["samples"][i].sample_id) for i in idx]  # None: never answered
        failed += sum(x is None for x in answers)
        served.append((idx, answers))
        stats.append(stat)
        if b - t0 >= seconds:
            break
    window_s = b - t0
    st["served"] = served
    done = sum(x is not None for _, answers in served for x in answers)
    edges = sum(st["qs"][i]["edge_index"].shape[1] for idx, _ in served for i in idx)
    counters = dict(
        questions=done, real_edges=edges,
        dispatch_s=sum(x.dispatch_s for x in stats), scoring_s=sum(x.scoring_s for x in stats),
        requests=[list(map(int, idx)) for idx, _ in served], **st["engine"],
        sizes=[(q["edge_index"].shape[1], len(q["entities"])) for q in st["qs"]])
    metrics = dict(serve_qps=done / window_s, serve_p95_ms=float(np.percentile(np.asarray(lat), 95)) * 1e3)
    attempted = sum(len(idx) for idx, _ in served)  # questions sent; failed: never answered
    return dict(metrics=metrics, attempted=attempted, failed=failed, window_s=window_s, counters=counters)


def finish(st: dict) -> None:
    """Keep what the comparison reads of the program (a sample of its
    projected table rows), then free the program's state."""
    rng = np.random.default_rng([st["seed"], 11])
    ent, rel = st["projected"]
    rows = np.concatenate([[0], rng.choice(ent.shape[0], size=min(4096, ent.shape[0]), replace=False)])
    st["table_rows"] = torch.as_tensor(rows, device=st["device"])
    st["prog_tables"] = (ent[st["table_rows"]].float().clone(), rel.float().clone())
    for key in ("projected", "bundle", "host"):
        st.pop(key, None)
    common.free(st["device"])


def picks(st: dict) -> list[tuple[int, int]]:
    """(request, position) of the answers compared: a sample drawn by the
    seed, with the answer to the largest question served in it."""
    tr = st["cell"]["traffic"]
    flat = [(r, i) for r, (idx, _) in enumerate(st["served"]) for i in range(len(idx))]
    rng = np.random.default_rng([st["seed"], 12])
    chosen = [flat[j] for j in rng.choice(len(flat), size=min(int(tr["check_answers"]), len(flat)), replace=False)]
    size = lambda ri: st["qs"][st["served"][ri[0]][0][ri[1]]]["edge_index"].shape[1]  # noqa: E731
    return [max(flat, key=size)] + chosen


def readings(st: dict, control: bool = False) -> dict[str, float]:
    """The comparison's numbers: ``table_err`` (projected table rows),
    ``score_err`` and ``topk_gap`` (answers, ``compare.topk_readings``).
    With ``control`` the answers and tables are the reference's own in the
    precision below the configuration's."""
    bf, low = ref.Prec("bfloat16"), ref.Prec("float8_e4m3fn")
    P, tables, k = st["P"], st["tables"], st["k"]
    m = st["cell"]["config"]["model"]
    rounds = (int(m["dde_rounds"]), int(m["dde_reverse_rounds"]))
    out = dict(table_err=0.0, score_err=0.0, topk_gap=0.0)
    with ref.exact_f32(), torch.no_grad():
        want_e = ref.entity_rows(P, tables[0], st["table_rows"])
        want_r = ref.relation_rows(P, tables[1], torch.arange(tables[1].shape[0], device=tables[1].device))
        got_e, got_r = (low.r(want_e), low.r(want_r)) if control else st["prog_tables"]
        out["table_err"] = max(float((got_e - want_e).abs().max()), float((got_r - want_r).abs().max()))
        for r, i in picks(st):
            qi = int(st["served"][r][0][i])
            q = st["qs"][qi]
            want = ref.question_scores(P, q, tables, qi, bf, *rounds)
            if control:
                v, ids = ref.topk(ref.question_scores(P, q, tables, qi, low, *rounds), k)
                ids, vals = ids.cpu().numpy(), v.to(torch.bfloat16).float().cpu().numpy()
            elif st["served"][r][1][i] is None:
                ids, vals = None, None
            else:
                ids, vals = st["served"][r][1][i]
            err, gap = compare.topk_readings(ids, vals, want, k)
            out["score_err"] = max(out["score_err"], err)
            out["topk_gap"] = max(out["topk_gap"], gap)
    return out

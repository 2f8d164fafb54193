"""Pooled driver: one device-resident index of the configuration's
``index_triples`` candidate triples drawn from its graph
(``ops.query.build_triple_index``, cast to bf16 once), then calls of
``queries`` questions to ``ops.score_kernels.query_topk_fused`` back to
back, each waited for until its top-k is on the host.

Traffic keys: ``queries`` (a call), ``query_split`` (the split whose
questions are queried), ``check_queries`` (answers the comparison samples).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks import gen
from benchmarks.drivers import common
from benchmarks.reference import compare, model as ref


def candidates(seed: int, g: dict, m: int, rounds: tuple[int, int], device) -> dict:
    """``m`` triples of whole questions' subgraphs (global embedding rows)
    with their DDE struct features, computed per subgraph."""
    nontext = gen.nontext_flags(seed, g)
    mean_edges = float(np.exp(float(g["lognorm_mean"]) + float(g["lognorm_sigma"]) ** 2 / 2))
    n = int(m / mean_edges * 1.2) + 8
    while True:
        qs = gen.split(seed, n, g, stream=1)
        if sum(q["edge_index"].shape[1] for q in qs) >= m:
            break
        n *= 2
    heads, rels, tails, structs = [], [], [], []
    for q in qs:
        rows = gen.embedding_rows(q["entities"], nontext)
        ei = torch.as_tensor(q["edge_index"], device=device)
        heads.append(rows[q["edge_index"][0]])
        tails.append(rows[q["edge_index"][1]])
        rels.append(q["relations"])
        structs.append(ref.edge_struct(ei, len(rows), torch.as_tensor(q["topics"], device=device), *rounds))
    cut = lambda xs: np.concatenate(xs)[:m]  # noqa: E731
    return dict(heads=cut(heads), rels=cut(rels), tails=cut(tails), struct=torch.cat(structs)[:m].contiguous())


def setup(cell: dict, seed: int, device: torch.device, spans) -> dict:
    from evi_rag_tpu_torch.ops.nnfn import tree_to
    from evi_rag_tpu_torch.ops.query import build_triple_index
    from evi_rag_tpu_torch.ops.score_kernels import prep_weights

    cfg, tr = cell["config"], cell["traffic"]
    g = cfg["graph"]
    d, h, s, k = common.model_dims(cfg)
    m = cfg["model"]
    rounds = (int(m["dde_rounds"]), int(m["dde_reverse_rounds"]))
    n_q = int(cfg["splits"][tr["query_split"]])
    with spans("setup.graphs"):
        cand = candidates(seed, g, int(cfg["index_triples"]), rounds, device)
    with spans("setup.tables"):
        ent, rel, qtab = gen.tables(seed, g, d, n_q, device, stream=1)
        P = gen.weights(seed, d, h, s, device)
    bundle = {"features": P}
    with spans("setup.index"):
        nontext_rows = torch.zeros(ent.shape[0], dtype=torch.bool, device=device)
        nontext_rows[0] = True
        index = build_triple_index(bundle, entity_emb=ent, relation_emb=rel, nontext_mask=nontext_rows,
                                   heads=cand["heads"], rels=cand["rels"], tails=cand["tails"],
                                   struct_raw=cand["struct"], device=device).to(dtype=torch.bfloat16)
        weights = prep_weights(tree_to(P, device))
    st = dict(cell=cell, seed=seed, device=device, cand=cand, tables=(ent, rel, qtab), P=P, bundle=bundle,
              index=index, weights=weights, k=k, calls=common.request_stream(seed, n_q, int(tr["queries"]), 0))
    with spans("setup.warmup"):
        for _ in range(2):
            _call(st, next(st["calls"]))
    return st


def _call(st: dict, idx):
    from evi_rag_tpu_torch.ops.score_kernels import query_topk_fused

    q = st["tables"][2][torch.as_tensor(idx, device=st["device"])].contiguous()
    v, i = query_topk_fused(st["bundle"], q, st["index"], k=st["k"], weights=st["weights"])
    return v.cpu().numpy(), i.cpu().numpy()


def window(st: dict, seconds: float, spans) -> dict:
    answered, failed = [], 0
    t0 = time.perf_counter()
    while True:
        idx = next(st["calls"])
        with spans("call"):
            vals, ids = _call(st, idx)
        answered.append((idx, vals, ids))
        failed += max(0, len(idx) - len(ids))
        b = time.perf_counter()
        if b - t0 >= seconds:
            break
    window_s = b - t0
    st["answered"] = answered
    n_q = sum(len(x[2]) for x in answered)
    counters = dict(calls=len(answered), queries=int(st["cell"]["traffic"]["queries"]),
                    candidates=int(st["index"].num_candidates))
    attempted = sum(len(x[0]) for x in answered)  # queries sent; failed: never answered
    return dict(metrics=dict(pooled_qps=n_q / window_s), attempted=attempted, failed=failed, window_s=window_s,
                counters=counters)


def finish(st: dict) -> None:
    """Keep a sample of the index rows the window read, then free the program."""
    rng = np.random.default_rng([st["seed"], 11])
    ix = st["index"]
    m = ix.num_candidates
    rows = torch.as_tensor(rng.choice(m, size=min(4096, m), replace=False), device=st["device"])
    st["index_rows"] = rows
    st["prog_rows"] = [x[rows].float().clone() for x in (ix.head_repr, ix.rel_repr, ix.tail_repr, ix.struct_raw)]
    for key in ("index", "weights", "bundle"):
        st.pop(key, None)
    common.free(st["device"])


def readings(st: dict, control: bool = False) -> dict[str, float]:
    """``index_err`` (the bf16 index rows against the reference's f32
    rows), ``score_err`` and ``topk_gap`` over a sample of the answered
    queries, every candidate scored.  With ``control`` the index rows and
    answers are the reference's own in the precision below."""
    bf, low = ref.Prec("bfloat16"), ref.Prec("float8_e4m3fn")
    P, (ent, rel, qtab), k, cand = st["P"], st["tables"], st["k"], st["cand"]
    dev = st["device"]
    out = dict(index_err=0.0, score_err=0.0, topk_gap=0.0)
    with ref.exact_f32(), torch.no_grad():
        rows = st["index_rows"]
        as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        head = ref.entity_rows(P, ent, as_t(cand["heads"]))
        tail = ref.entity_rows(P, ent, as_t(cand["tails"]))
        relr = ref.relation_rows(P, rel, as_t(cand["rels"]))
        want = [head[rows], relr[rows], tail[rows], cand["struct"][rows]]
        got = [low.r(x) for x in want] if control else st["prog_rows"]
        out["index_err"] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        rng = np.random.default_rng([st["seed"], 12])
        flat = [(c, j) for c in range(len(st["answered"])) for j in range(len(st["answered"][c][0]))]
        n = min(int(st["cell"]["traffic"]["check_queries"]), len(flat))
        chosen = [flat[x] for x in rng.choice(len(flat), size=n, replace=False)]
        q_rows = as_t(np.array([st["answered"][c][0][j] for c, j in chosen]))
        want_s = ref.pooled_scores(P, qtab[q_rows], head, relr, tail, cand["struct"], bf)
        if control:
            low_v, low_i = ref.topk(ref.pooled_scores(P, qtab[q_rows], head, relr, tail, cand["struct"], low), k)
        for x, (c, j) in enumerate(chosen):
            if control:
                ids, vals = low_i[x].cpu().numpy(), low_v[x].to(torch.bfloat16).float().cpu().numpy()
            elif j >= len(st["answered"][c][2]):  # a query the call never answered
                ids, vals = None, None
            else:
                ids, vals = st["answered"][c][2][j], st["answered"][c][1][j]
            err, gap = compare.topk_readings(ids, vals, want_s[x], k)
            out["score_err"] = max(out["score_err"], err)
            out["topk_gap"] = max(out["topk_gap"], gap)
    return out

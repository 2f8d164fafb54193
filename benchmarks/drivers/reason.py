"""Reason driver: the reasoner stage with its in-process LLM.  One
closed-loop client; a request is ``questions`` distinct test questions of
the retriever's configuration (the configuration's ``retriever``), served
top-k by ``serving.serve_split`` (the serve driver's engine and set-up;
``retriever`` names a configuration, or is one),
each asked at every evidence window of ``windows`` through
``eval.prompting.build_triplet_prompt`` and ``eval.reasoner.chat_messages``,
all the request's chats answered at once by the ``local`` backend
(``eval.llm_client.init_llm``), ``answer_tokens`` new tokens each.

Entity and relation names come from the seed at Freebase-like lengths:
entities of 1-4 capitalised words, relations ``domain.type.property`` of
one or two words a part.  The backend is built from the configuration's
published keys (written to ``.cache/`` as its model file, named by its
content) and the seed; then the benchmark's own weights
(``llm_weights.MoonlightWeights``, from the seed) are copied into its model in
place, so that the comparison holds the program to weights it did not draw.

``correct``: for ``check_sequences`` chats of the window's last request
(its longest, and one drawn by the seed from each window), the logits the
timed path produced at the last prompt position and at every decode step,
against the plain reference's full forward over prompt + generated ids
(``reference/moonlight.py``, f32, layer by layer from the benchmark's
bf16 weights), the reference taking the experts the program chose at each
position and layer (one rounding flips near-tied choices of random
weights, and a flip spreads to every later token).  ``route_gap``: the
widest margin by which a chosen expert's score + bias lies below the
reference's own k-th best.  ``logit_err``: the worst chat's relative error (Frobenius
norm over its positions); ``topk_gap``: the widest margin by which one of
the program's top ``TOPK`` ids at a position lies below the reference's
``TOPK``-th best there, in units of the reference logits' standard
deviation at that position.  The control is the reference with every weight
matrix rounded through e4m3 (one scale a tensor), its own choices of
experts and its logits, in the program's place.

Traffic keys: ``split``, ``questions``, ``windows``, ``answer_tokens``,
``check_sequences``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

import numpy as np
import torch

from benchmarks import harness, llm_weights
from benchmarks.drivers import common, serve
from benchmarks.reference import moonlight as ref

# Keys of the configuration file that are the benchmark's, not the model's.
OWN = ("source", "reduced", "assumed", "deployment", "retriever", "names")
TOPK = 8


def model_config(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k not in OWN}


def _words(rng, n: int, lo: int, hi: int) -> list[str]:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, int(m))) for m in rng.integers(lo, hi + 1, n)]


def names(seed: int, g: dict, spec: dict) -> tuple[list[str], list[str]]:
    """(entity names, relation names) of a graph's pools from the seed."""
    rng = np.random.default_rng([seed, 21])
    pool = _words(rng, int(spec["pool"]), *spec["word_letters"])
    cap = [w.capitalize() for w in pool]
    n_ent = int(g["entities"])
    counts = rng.integers(spec["entity_words"][0], spec["entity_words"][1] + 1, n_ent)
    picks = rng.integers(0, len(pool), (n_ent, spec["entity_words"][1]))
    ents = [" ".join(cap[j] for j in picks[i, :counts[i]]) for i in range(n_ent)]
    part = lambda: "_".join(pool[j] for j in rng.integers(0, len(pool), int(rng.integers(1, 3))))  # noqa: E731
    rels = [f"{part()}.{part()}.{part()}" for _ in range(int(g["relations"]))]
    return ents, rels


def load(mine: dict[str, torch.Tensor], weights) -> None:
    """Copy ``weights`` into the program's tensors ``mine`` in place, each
    in the program's type; a name or shape the program lacks or adds is
    refused."""
    if set(mine) != set(weights):
        raise ValueError(f"the program's weights differ in name: {sorted(set(mine) ^ set(weights))[:8]}")
    for k, want in weights.items():
        if tuple(mine[k].shape) != tuple(want.shape):
            raise ValueError(f"the program's {k} is {tuple(mine[k].shape)}, not {tuple(want.shape)}")
        mine[k].copy_(want)


def setup(cell: dict, seed: int, device: torch.device, spans) -> dict:
    from evi_rag_tpu_torch.eval.llm_client import LLMConfig, init_llm

    cfg, tr = cell["config"], cell["traffic"]
    with spans("setup.model"):  # first: a program without the backend stops here
        text = json.dumps(model_config(cfg), sort_keys=True)
        path = harness.HERE / ".cache" / f"model.{hashlib.sha1(text.encode()).hexdigest()[:16]}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, path)  # whole, whatever other run writes the same file
        llm = init_llm(LLMConfig(model_name="moonshotai/Moonlight-16B-A3B", backend="local", model_file=str(path),
                                 seed=seed, device=str(device), max_tokens=int(tr["answer_tokens"])))
    with spans("setup.weights"):
        weights = llm_weights.MoonlightWeights(seed, model_config(cfg), device)
        load(llm.weights, weights)
    rcfg = cfg["retriever"] if isinstance(cfg["retriever"], dict) else harness.config(cfg["retriever"])
    rcell = dict(cell, config=rcfg, traffic=dict(kind="serve", split=tr["split"], request=int(tr["questions"]),
                                                 edge_rule="clip"))
    sst = serve.setup(rcell, seed, device, spans)
    with spans("setup.names"):
        ents, rels = names(seed, rcfg["graph"], cfg["names"])
        rng = np.random.default_rng([seed, 22])
        ask = []
        for q in sst["qs"]:
            topic = ents[int(q["entities"][q["topics"][0]])]
            prop = rels[int(rng.integers(len(rels)))].rsplit(".", 1)[-1].replace("_", " ")
            ask.append(f"What is the {prop} of {topic}?")
    st = dict(cell=cell, seed=seed, device=device, llm=llm, weights=weights, serve=sst, ents=ents, rels=rels,
              ask=ask, last=None)
    with spans("setup.warmup"):  # one request: every kernel of prefill and decode
        _request(st, next(sst["requests"]), 0)
    return st


def _chats(st: dict, idx, res):
    from evi_rag_tpu_torch.eval.prompting import build_triplet_prompt
    from evi_rag_tpu_torch.eval.reasoner import chat_messages

    got = {r.sample_id: r.edge_ids for r in res}
    chats, failed = [], 0
    for i in idx:
        s, q = st["serve"]["samples"][i], st["serve"]["qs"][i]
        edges = got.get(s.sample_id)
        if edges is None:
            failed += 1
            continue
        ent = q["entities"]
        trip = [(st["ents"][int(ent[q["edge_index"][0, e]])], st["rels"][int(q["relations"][e])],
                 st["ents"][int(ent[q["edge_index"][1, e]])]) for e in np.asarray(edges)]
        for k in st["cell"]["traffic"]["windows"]:
            chats.append(chat_messages({"prompt": build_triplet_prompt(st["ask"][i], trip, int(k))}))
    return chats, failed


def picks(st: dict, lengths: list[int], r: int) -> list[int]:
    """The chats compared of request ``r``: its longest, then one drawn by
    the seed from each window (chats lie question-major)."""
    tr = st["cell"]["traffic"]
    nw = len(tr["windows"])
    rng = np.random.default_rng([st["seed"], 23, r])
    longest = int(np.argmax(lengths))
    out = [longest]
    for w in range(nw):
        if len(out) >= int(tr["check_sequences"]):
            break
        cand = [j for j in range(w, len(lengths), nw) if j not in out]
        if cand:
            out.append(int(rng.choice(cand)))
    return out


def _request(st: dict, idx, r: int):
    """Serve, prompt and answer one request; (answered questions, failed)."""
    res, _ = serve._serve(st["serve"], idx)
    chats, failed = _chats(st, idx, res)
    lengths = [sum(len(m["content"]) for m in c) for c in chats]
    keep = picks(st, lengths, r)
    replies, prompts, tokens, kept = st["llm"].run(chats, keep)
    st["last"] = dict(prompts=[prompts[j] for j in keep], tokens=[tokens[j] for j in keep], kept=kept)
    nw = len(st["cell"]["traffic"]["windows"])
    return sum(1 for j in range(0, len(replies), nw) if all(replies[j:j + nw])), failed


def window(st: dict, seconds: float, spans) -> dict:
    done = failed = attempted = 0
    requests = 0
    t0 = time.perf_counter()
    while True:
        idx = next(st["serve"]["requests"])
        with spans("request"):
            ok, bad = _request(st, idx, requests + 1)
        requests += 1
        b = time.perf_counter()
        done, failed, attempted = done + ok, failed + bad, attempted + len(idx)
        if b - t0 >= seconds:
            break
    window_s = b - t0
    return dict(metrics=dict(serve_qps=done / window_s), attempted=attempted, failed=failed, window_s=window_s,
                counters=dict(questions=done, requests=requests))


def finish(st: dict) -> None:
    """Keep the weights and the last request's compared chats; free the
    retriever."""
    st.pop("serve", None)
    common.free(st["device"])


def readings(st: dict, control: bool = False) -> dict[str, float]:
    last, weights = st["last"], st["weights"]
    cfg = model_config(st["cell"]["config"])
    seqs = [torch.as_tensor(np.concatenate([p, t[:-1]])) for p, t in zip(last["prompts"], last["tokens"])]
    starts = [len(p) - 1 for p in last["prompts"]]
    if control:
        got, routes, _ = ref.forward(weights, cfg, seqs, starts, weight_cast=ref.e4m3)
    else:
        got, routes = list(last["kept"].logits), last["kept"].routes
    inf = dict(logit_err=float("inf"), topk_gap=float("inf"), route_gap=float("inf"))
    if any(r.shape[1] != len(s) for r, s in zip(routes, seqs)):
        return inf
    want, _, route_gap = ref.forward(weights, cfg, seqs, starts, routes=routes)
    err = gap = 0.0
    for g, w in zip(got, want):
        g = g.float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            return inf
        err = max(err, float((g - w).norm() / w.norm()))
        kth = torch.topk(w, TOPK, dim=-1).values[:, -1]
        mine = w.gather(1, torch.topk(g, TOPK, dim=-1).indices)
        gap = max(gap, float(((kth[:, None] - mine).clamp(min=0) / w.std(-1, keepdim=True)).max()))
    return dict(logit_err=err, topk_gap=gap, route_gap=route_gap)

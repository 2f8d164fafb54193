"""Reason driver for Kimi-Linear-48B-A3B: the reasoner stage over long
evidence windows, with the in-process LLM holding this card's share of the
experts.  As ``drivers/reason.py`` (its request, window and clean-up are
that driver's): one closed-loop client; a request is ``questions``
distinct test questions of the retriever's configuration (the
configuration's ``retriever``, its top-k set to ``retriever_k``), whose
subgraphs hold ``edge_min``-``edge_max`` edges (``edge_rule``), served by
``serving.serve_split``, each asked at every evidence window of
``windows``, all the request's chats answered at once by the ``local``
backend, ``answer_tokens`` new tokens each.  The backend is built from the
configuration's published keys and the seed, then the benchmark's own
weights (``llm_weights_kimi.KimiWeights``) are copied into its model in
place.

``correct``: for ``check_sequences`` chats of the window's last request
(its longest, and one drawn by the seed from each window), against the
plain reference's full forward over prompt + generated ids
(``reference/kimi_linear.py``, f32, the program's experts taken):
``logit_err``, ``topk_gap`` and ``route_gap`` as ``drivers/reason.py``'s,
and ``state_err``, the worst over the compared chats of the relative error
(Frobenius norm) of the state of the first KDA layer after the prompt.  That
layer's inputs are the embedding rows, the same on both sides, so its state
reads the recurrence and the precision it is kept in; a deeper layer's
reads mostly the bf16 forward's drift below it, which ``logit_err`` holds.
Two controls take
the program's place: ``e4m3`` (every weight of two or more dims rounded
through e4m3) and ``state_bf16`` (the KDA state rounded to bf16 after every
token); each its own choices of experts, logits and states.

Traffic keys: ``split``, ``questions``, ``windows``, ``answer_tokens``,
``check_sequences``, ``edge_min``, ``edge_max``, ``edge_rule``.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os

import numpy as np
import torch

from benchmarks import harness, llm_weights_kimi
from benchmarks.drivers import reason, serve
from benchmarks.reference import kimi_linear as ref

# Keys of the configuration file that are the benchmark's, not the model's.
OWN = reason.OWN + ("retriever_k",)
CONTROLS = ("e4m3", "state_bf16")
MODEL_NAME = "moonshotai/Kimi-Linear-48B-A3B-Instruct"

window = reason.window
finish = reason.finish


def model_config(cfg: dict) -> dict:
    return {k: v for k, v in cfg.items() if k not in OWN}


def retriever_config(cfg: dict) -> dict:
    """The retriever's configuration (named, or given whole) at top-k
    ``retriever_k``."""
    rcfg = copy.deepcopy(cfg["retriever"] if isinstance(cfg["retriever"], dict) else harness.config(cfg["retriever"]))
    rcfg["model"]["k"] = int(cfg["retriever_k"])
    return rcfg


def setup(cell: dict, seed: int, device: torch.device, spans) -> dict:
    from evi_rag_tpu_torch.eval.llm_client import LLMConfig, init_llm

    cfg, tr = cell["config"], cell["traffic"]
    with spans("setup.model"):  # first: a program without this model stops here
        text = json.dumps(model_config(cfg), sort_keys=True)
        path = harness.HERE / ".cache" / f"model.{hashlib.sha1(text.encode()).hexdigest()[:16]}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(text)
        os.replace(tmp, path)
        llm = init_llm(LLMConfig(model_name=MODEL_NAME, backend="local", model_file=str(path), seed=seed,
                                 device=str(device), max_tokens=int(tr["answer_tokens"])))
    with spans("setup.weights"):
        weights = llm_weights_kimi.KimiWeights(seed, model_config(cfg), device)
        reason.load(llm.weights, weights)
    rcfg = retriever_config(cfg)
    rcell = dict(cell, config=rcfg, traffic=dict(kind="serve", split=tr["split"], request=int(tr["questions"]),
                                                 edge_min=int(tr["edge_min"]), edge_max=int(tr["edge_max"]),
                                                 edge_rule=tr["edge_rule"]))
    sst = serve.setup(rcell, seed, device, spans)
    with spans("setup.names"):
        ents, rels = reason.names(seed, rcfg["graph"], cfg["names"])
        rng = np.random.default_rng([seed, 22])
        ask = []
        for q in sst["qs"]:
            topic = ents[int(q["entities"][q["topics"][0]])]
            prop = rels[int(rng.integers(len(rels)))].rsplit(".", 1)[-1].replace("_", " ")
            ask.append(f"What is the {prop} of {topic}?")
    st = dict(cell=cell, seed=seed, device=device, llm=llm, weights=weights, serve=sst, ents=ents, rels=rels,
              ask=ask, last=None)
    with spans("setup.warmup"):  # one request: every kernel of prefill and decode
        reason._request(st, next(sst["requests"]), 0)
    return st


def readings(st: dict, control: bool | str = False) -> dict[str, float]:
    """The comparison's numbers for the program, or with ``control`` for
    one control (``"e4m3"``, ``"state_bf16"``) or both (True: each number
    under ``<control>.<name>``)."""
    if control is True:
        return {f"{name}.{k}": v for name in CONTROLS for k, v in readings(st, name).items()}
    last, weights = st["last"], st["weights"]
    cfg = model_config(st["cell"]["config"])
    seqs = [torch.as_tensor(np.concatenate([p, t[:-1]])) for p, t in zip(last["prompts"], last["tokens"])]
    starts = [len(p) - 1 for p in last["prompts"]]
    if control:
        cast = dict(weight_cast=ref.e4m3) if control == "e4m3" else dict(state_cast=ref.bf16_round)
        got, routes, _, got_states = ref.forward(weights, cfg, seqs, starts, **cast)
    else:
        kept = last["kept"]
        got, routes, got_states = list(kept.logits), kept.routes, kept.states
    inf = dict(logit_err=float("inf"), topk_gap=float("inf"), route_gap=float("inf"), state_err=float("inf"))
    if got_states is None or any(r.shape[1] != len(s) for r, s in zip(routes, seqs)):
        return inf
    want, _, route_gap, states = ref.forward(weights, cfg, seqs, starts, routes=routes)
    err = gap = state_err = 0.0
    for g, w, gs, ws in zip(got, want, got_states, states):
        g = g.float()
        if g.shape != w.shape or not torch.isfinite(g).all() or gs.shape != ws.shape or not torch.isfinite(gs).all():
            return inf
        err = max(err, float((g - w).norm() / w.norm()))
        kth = torch.topk(w, reason.TOPK, dim=-1).values[:, -1]
        mine = w.gather(1, torch.topk(g, reason.TOPK, dim=-1).indices)
        gap = max(gap, float(((kth[:, None] - mine).clamp(min=0) / w.std(-1, keepdim=True)).max()))
        state_err = max(state_err, float((gs[0] - ws[0]).norm() / ws[0].norm()))
    return dict(logit_err=err, topk_gap=gap, route_gap=route_gap, state_err=state_err)

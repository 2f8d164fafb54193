"""The reference's training steps: the retriever's forward on the real
graphs of each batch (no padding), the grouped InfoNCE loss, autograd's
gradients, the global-norm clip and AdamW by the optax rules, the learning
rate by its schedule.  Nothing here imports the program.

The random draws are the program's documented ones, from a generator of
the same seed on the same device: per step, a keep mask ``[E, H]`` for each
direction, then ``[E]`` hide-and-seek uniforms, over the batch's ``E`` edge
slots; a batch lays its graphs' edges end to end from slot 0, so the real
edges take the first rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.reference import model as ref


def lr_at(o: dict, count: int) -> float:
    """The learning rate of update ``count`` (0 first)."""
    peak, warm = float(o["learning_rate"]), int(o["warmup_steps"])
    if count < warm:
        return peak * count / warm
    if o["schedule"] == "constant":
        return peak
    if o["schedule"] != "cosine":
        raise ValueError(f"schedule {o['schedule']!r} is not in the reference")
    decay = max(int(o["total_steps"]), warm + 1) - warm
    return peak * 0.5 * (1 + math.cos(math.pi * min(count - warm, decay) / decay))


def graph_inputs(qs: list[dict], idx: list[int], dev) -> dict:
    """The questions ``idx`` laid end to end: global edge index, relations,
    node rows, topic and answer flags, labels, each edge's graph."""
    ei, rel, rows, topic, qa, labels, eg = [], [], [], [], [], [], []
    off = 0
    for g, i in enumerate(idx):
        q = qs[i]
        n = len(q["rows"])
        ei.append(q["edge_index"].astype(np.int64) + off)
        rel.append(q["relations"])
        rows.append(q["rows"])
        topic.append(q["topics"].astype(np.int64) + off)
        flags = np.zeros(n, bool)
        flags[q["topics"]] = True
        flags[q["answers"]] = True
        qa.append(flags)
        labels.append(q["labels"])
        eg.append(np.full(q["edge_index"].shape[1], g))
        off += n
    t = lambda xs: torch.as_tensor(np.concatenate(xs, axis=-1), device=dev)  # noqa: E731
    return dict(edge_index=t(ei), relations=t(rel), rows=t(rows), topics=t(topic), qa=t(qa), labels=t(labels),
                edge_graph=t(eg), num_nodes=off, q_rows=torch.as_tensor(np.asarray(idx), device=dev))


def loss_of(P: dict, inp: dict, tables: tuple, cfg: dict, prec: ref.Prec, draws) -> torch.Tensor:
    m = cfg["model"]
    ent, rel, qtab = tables
    ei = inp["edge_index"]
    node_rep = ref.entity_rows(P, ent, inp["rows"], prec)
    h, t = node_rep[ei[0]], node_rep[ei[1]]
    r = ref.relation_rows(P, rel, inp["relations"], prec)
    gate, bias = ref.query_terms(P, qtab[inp["q_rows"]], prec, round_input=True)
    eg = inp["edge_graph"]
    st = prec.r(ref.edge_struct(ei, inp["num_nodes"], inp["topics"], int(m["dde_rounds"]),
                                int(m["dde_reverse_rounds"])))
    keep_f, keep_b, u = draws
    hs = m["hide_seek"]
    near = inp["qa"][ei[0]] | inp["qa"][ei[1]]
    p = torch.where(near, torch.tensor(float(hs["p_near"]), device=ei.device), torch.tensor(float(hs["p_far"]), device=ei.device))
    b = torch.where(near, torch.tensor(float(hs["bias_near"]), device=ei.device),
                    torch.tensor(float(hs["bias_far"]), device=ei.device))
    extra = torch.where(u < p, b, torch.zeros_like(b)) if hs["enabled"] else None
    logits = ref.twin_scores(P, gate[eg], bias[eg], h, r, t, st, prec, keep=(keep_f, keep_b),
                             p_drop=float(m["dropout_p"]), extra=extra)
    s = logits / float(cfg["train"]["infonce_temperature"])
    n_g = int(inp["q_rows"].shape[0])
    pos = inp["labels"] > 0.5
    per = []
    for g in range(n_g):
        mine = eg == g
        if not bool((pos & mine).any()) or not bool((~pos & mine).any()):
            continue
        per.append(torch.logsumexp(s[mine], 0) - torch.logsumexp(s[mine & pos], 0))
    return torch.stack(per).mean() if per else s.sum() * 0.0


def run(cfg: dict, P0: dict, qs: list[dict], tables: tuple, steps: list[list[int]], prec: ref.Prec,
        draw_seed: int, bucket_edges: int, *, half: bool = False) -> dict:
    """The first steps from parameters ``P0``: each step's loss, the first
    gradient after the clip, each parameter's change.  ``half`` leaves out
    the second half of every batch (a fault, for the comparison's test)."""
    dev = tables[0].device
    o, m = cfg["train"]["optimizer"], cfg["model"]
    hidden, keep_p = int(m["hidden_dim"]), 1.0 - float(m["dropout_p"])
    init = ref.flat(P0)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    mu = {k: torch.zeros_like(v) for k, v in init.items()}
    nu = {k: torch.zeros_like(v) for k, v in init.items()}
    gen = torch.Generator(device=dev).manual_seed(draw_seed)
    losses, first = [], None
    b1, b2 = float(o["b1"]), float(o["b2"])
    for count, idx in enumerate(steps):
        e_slots = bucket_edges
        kf = torch.rand(e_slots, hidden, device=dev, generator=gen) < keep_p
        kb = torch.rand(e_slots, hidden, device=dev, generator=gen) < keep_p
        u = torch.rand(e_slots, device=dev, generator=gen)
        use = idx[: len(idx) // 2] if half else idx
        inp = graph_inputs(qs, use, dev)
        e = int(inp["edge_index"].shape[1])
        loss = loss_of(ref.unflat(leaves), inp, tables, cfg, prec, (kf[:e], kb[:e], u[:e]))
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)))
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k])) for k, g in grads.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = float(o["grad_clip_norm"])
        if float(norm) >= clip:
            grads = {k: g / norm * clip for k, g in grads.items()}
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        lr = lr_at(o, count)
        with torch.no_grad():
            for k, g in grads.items():
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * g * g + b2 * nu[k]
                upd = (mu[k] / (1 - b1 ** (count + 1))) / (torch.sqrt(nu[k] / (1 - b2 ** (count + 1))) + 1e-8)
                upd = upd + float(o["weight_decay"]) * leaves[k]
                leaves[k] -= lr * upd
        losses.append(float(loss.detach()))
    change = {k: (v.detach() - init[k]) for k, v in leaves.items()}
    return dict(losses=losses, first_grad=first, change=change)

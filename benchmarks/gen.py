"""The one generator of the benchmark's inputs: knowledge-graph subgraphs
with planted answer chains (host, NumPy) and embedding tables (card, a
``torch.Generator``), from a configuration and a traffic mix, by seed.

The topology rule is that of ``scripts/make_synthetic_webqsp.py`` (the
WebQSP / CWQ presets): a log-normal edge count clipped to a range, nodes =
max(16, edges ** 0.78) drawn from a shared entity pool, one or two topic
entities, one to three answers, a 1-, 2- or 3-hop planted chain per answer
by the hop mix, distractor edges of which ~35% leave a chain node, answers
of multi-hop questions kept off the distractors, no direct topic-to-m2 edge
on 3-hop questions, no self-loop and no repeated (head, relation, tail).
The chain edges are the positives.  Text is left out: the entity, relation
and question embeddings are random rows of the configuration's width.

Every seed gets the same multiset of edge counts (stratified quantiles of
the clipped log-normal), in its own order, so the work a cell does depends
on the seed only through which graph comes when.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np


def edge_counts(n: int, mean: float, sigma: float, lo: int, hi: int, rule: str = "clip") -> np.ndarray:
    """[n] edge counts: quantiles at (i + 0.5) / n of the log-normal
    clipped to [lo, hi] (``clip``), or of the log-normal restricted to
    [lo, hi] (``truncate``)."""
    from statistics import NormalDist

    nd = NormalDist()
    if rule == "clip":
        a, b = 0.0, 1.0
    elif rule == "truncate":
        a, b = (nd.cdf((math.log(x) - mean) / sigma) for x in (lo, hi + 1))
    else:
        raise ValueError(f"unknown edge rule {rule!r}")
    z = np.array([nd.inv_cdf(a + (b - a) * (i + 0.5) / n) for i in range(n)])
    return np.clip(np.exp(mean + sigma * z), lo, hi).astype(np.int64)


def hop_counts(n: int, mix) -> np.ndarray:
    """[n] hop counts 1..3 in the mix's proportions (largest remainders)."""
    p = np.asarray(mix, np.float64) / sum(mix)
    base = np.floor(p * n).astype(int)
    rest = n - base.sum()
    base[np.argsort(-(p * n - base))[:rest]] += 1
    return np.repeat(np.arange(1, 4), base)


def question(rng: np.random.Generator, n_edges: int, hops: int, g: dict[str, Any]) -> dict[str, np.ndarray]:
    """One subgraph: local edges, relations, global entity ids, topic and
    answer locals, positive labels."""
    pool, n_rel = int(g["entities"]), int(g["relations"])
    n_nodes = max(int(g["min_nodes"]), int(n_edges ** float(g["node_exponent"])))
    nodes = rng.choice(pool, size=n_nodes, replace=False)
    n_topics = 1 if rng.random() < 0.85 else 2
    n_answers = 1 + int(rng.random() < 0.4) + int(rng.random() < 0.15)
    topics = np.arange(n_topics)
    answers = np.arange(n_topics, n_topics + n_answers)
    mids0 = n_topics + n_answers
    gold = rng.integers(n_rel, size=hops)
    heads, rels, tails = [], [], []
    for a_i in range(n_answers):  # chain topic -> m1 [-> m2] -> answer
        chain = [a_i % n_topics] + [mids0 + j * n_answers + a_i for j in range(hops - 1)] + [n_topics + a_i]
        for j in range(hops):
            heads.append(chain[j]); rels.append(int(gold[j])); tails.append(chain[j + 1])  # noqa: E702
    n_pos = len(heads)
    taken = (np.asarray(heads, np.int64) * n_rel + np.asarray(rels)) * n_nodes + np.asarray(tails)
    if hops >= 2:
        hot = np.concatenate([topics, np.arange(mids0, mids0 + (hops - 1) * n_answers)])
        open_ids = np.setdiff1d(np.arange(n_nodes), answers)
    else:
        hot = np.concatenate([topics, answers])
        open_ids = np.arange(n_nodes)
    last_mids = np.arange(mids0 + n_answers, mids0 + 2 * n_answers) if hops == 3 else np.zeros(0, np.int64)
    h_all, r_all, t_all = [np.asarray(heads)], [np.asarray(rels)], [np.asarray(tails)]
    need = n_edges - n_pos
    while need > 0:
        b = need + need // 4 + 16
        h = np.where(rng.random(b) < 0.35, rng.choice(hot, size=b), open_ids[rng.integers(open_ids.size, size=b)])
        t = open_ids[rng.integers(open_ids.size, size=b)]
        r = rng.integers(n_rel, size=b)
        ok = h != t
        if last_mids.size:
            bad = (np.isin(h, topics) & np.isin(t, last_mids)) | (np.isin(t, topics) & np.isin(h, last_mids))
            ok &= ~bad
        h, r, t = h[ok], r[ok], t[ok]
        key = (h.astype(np.int64) * n_rel + r) * n_nodes + t
        _, first = np.unique(key, return_index=True)
        first.sort()
        fresh = first[~np.isin(key[first], taken)][:need]
        taken = np.concatenate([taken, key[fresh]])
        h_all.append(h[fresh]); r_all.append(r[fresh]); t_all.append(t[fresh])  # noqa: E702
        need -= len(fresh)
    ei = np.stack([np.concatenate(h_all), np.concatenate(t_all)]).astype(np.int32)
    labels = np.zeros(ei.shape[1], np.float32)
    labels[:n_pos] = 1.0
    return dict(edge_index=ei, relations=np.concatenate(r_all).astype(np.int32), entities=nodes.astype(np.int64),
                topics=topics.astype(np.int32), answers=answers.astype(np.int32), labels=labels, hops=hops)


def split(seed: int, n: int, g: dict[str, Any], *, edge_min: int | None = None, edge_max: int | None = None,
          rule: str = "clip", stream: int = 0) -> list[dict[str, np.ndarray]]:
    """``n`` questions of graph settings ``g`` (a configuration's ``graph``),
    the edge range optionally narrowed (a traffic mix's cut; ``rule`` as in
    ``edge_counts``).  ``stream`` keeps the splits of one run apart."""
    lo = int(g["edge_min"] if edge_min is None else edge_min)
    hi = int(g["edge_max"] if edge_max is None else edge_max)
    rng = np.random.default_rng([seed, stream])
    counts = edge_counts(n, float(g["lognorm_mean"]), float(g["lognorm_sigma"]), lo, hi, rule)
    hops = hop_counts(n, g["hop_mix"])
    order, hop_order = rng.permutation(n), rng.permutation(n)
    return [question(rng, int(counts[order[i]]), int(hops[hop_order[i]]), g) for i in range(n)]


def embedding_rows(entities: np.ndarray, nontext: np.ndarray) -> np.ndarray:
    """Embedding-table rows of global entity ids: row 0 for non-text (CVT)
    entities, id + 1 for the rest."""
    return np.where(nontext[entities], 0, entities + 1).astype(np.int32)


def nontext_flags(seed: int, g: dict[str, Any]) -> np.ndarray:
    """[entities] bool: which pool entities are non-text (the preset's 25%)."""
    rng = np.random.default_rng([seed, 99])
    return rng.random(int(g["entities"])) < float(g["nontext_share"])


def tables(seed: int, g: dict[str, Any], d: int, questions: int, device, stream: int = 0):
    """(entity [V + 1, D], relation [R, D], question [Q, D]) f32 tables on
    ``device``: unit-norm random rows (a sentence encoder's outputs are
    normalised), row 0 of the entity table the non-text row, in three draws
    from one generator."""
    import torch

    gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + 17 * stream) % (1 << 62))

    def rows(n: int) -> torch.Tensor:
        x = torch.randn((n, d), generator=gen, device=device, dtype=torch.float32)
        return x / x.norm(dim=1, keepdim=True)

    return rows(int(g["entities"]) + 1), rows(int(g["relations"])), rows(questions)


# (module path, leaf, shape of the leaf by (D, H, S)) of the retriever's
# parameters, in the flax layout: kernels [in, out].
def _leaves(d: int, h: int, s: int):
    out = []
    for name in ("entity_proj", "relation_proj", "query_proj"):
        out += [(f"{name}/proj/kernel", (d, d)), (f"{name}/proj/bias", (d,))]
    out += [("non_text_entity_emb", (d,))]
    for name, (i, o) in (("q_gate", (d, d)), ("q_bias", (d, d)), ("struct_proj", (s, d)),
                         ("struct_gate", (d, 1)), ("state_net_0", (3 * d + 1, h)),
                         ("state_net_1", (h, h)), ("score_head", (h, 1))):
        out += [(f"{name}/kernel", (i, o)), (f"{name}/bias", (o,))]
    for name, n in (("struct_norm", d), ("state_norm", h)):
        out += [(f"{name}/scale", (n,)), (f"{name}/bias", (n,))]
    return out


def weights(seed: int, d: int, h: int, s: int, device) -> dict:
    """The retriever's parameters as a flax tree of f32 tensors on
    ``device``, from one draw: kernels N(0, 1 / fan_in), biases N(0, 0.02),
    LayerNorm scales 1 + N(0, 0.05) and shifts N(0, 0.05), the non-text
    entity row N(0, 1)."""
    import torch

    leaves = _leaves(d, h, s)
    sizes = [math.prod(shape) for _, shape in leaves]
    gen = torch.Generator(device=device).manual_seed((int(seed) * 104729 + 3) % (1 << 62))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for (path, shape), n in zip(leaves, sizes):
        x = flat[off:off + n].reshape(shape)
        off += n
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "kernel":
            x = x / math.sqrt(shape[0])
        elif path.endswith("norm/scale"):
            x = 1.0 + 0.05 * x
        elif path.endswith("norm/bias"):
            x = 0.05 * x
        elif leaf == "bias":
            x = 0.02 * x
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = x.contiguous()
    return tree

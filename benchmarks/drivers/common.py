"""What the drivers share: the program's input records, request streams,
the card's memory record."""

from __future__ import annotations

import numpy as np

from benchmarks import gen


def samples(qs: list[dict], nontext: np.ndarray, prefix: str):
    """``RetrievalSample``s of generated questions (question ``i`` reads row
    ``i`` of its split's question table); sets ``rows`` on each dict."""
    from evi_rag_tpu_torch.data.sample import RetrievalSample

    out = []
    for i, q in enumerate(qs):
        q["rows"] = gen.embedding_rows(q["entities"], nontext)
        n_pairs = len(q["answers"])
        out.append(RetrievalSample(
            sample_id=f"{prefix}-{i}", num_nodes=len(q["entities"]), edge_index=q["edge_index"],
            edge_relations=q["relations"], node_embedding_ids=q["rows"], topic_locals=q["topics"],
            answer_locals=q["answers"], edge_labels=q["labels"],
            pair_start_local=q["topics"][np.arange(n_pairs) % len(q["topics"])].astype(np.int32),
            pair_answer_local=q["answers"].astype(np.int32),
            pair_shortest_len=np.full(n_pairs, q["hops"], np.int32), question_id=i,
            node_entity_ids=q["entities"]))
    return out


def request_stream(seed: int, n: int, size: int, stream: int):
    """Endless index arrays of ``size`` distinct items out of ``n``: each
    round is a fresh permutation cut into whole requests."""
    rng = np.random.default_rng([seed, 1000 + stream])
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - size + 1, size):
            yield perm[i:i + size]


def model_dims(cfg: dict) -> tuple[int, int, int, int]:
    """(D, H, S, k) of a configuration."""
    m = cfg["model"]
    s = 2 * 2 * (1 + int(m["dde_rounds"]) + int(m["dde_reverse_rounds"]))
    return int(m["emb_dim"]), int(m["hidden_dim"]), s, int(m["k"])


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

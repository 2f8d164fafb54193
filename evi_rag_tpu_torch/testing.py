"""A fixed check of the per-question kernel's output, shared by
``chip_smoke.py`` and ``tests/test_torch_card.py``.

``pqt_digest`` runs ``per_question_topk`` on a fixed input made with numpy
from seeds and hashes its output; ``PQT_DIGEST`` is that hash from the kernel
as it stood before its device code moved into ``csrc/twin_score.cuh``, so a
match shows the move changed no output bit.  Needs the card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

# sha256 of the (vals, ids) bytes, taken on an NVIDIA H100 80GB HBM3.
PQT_DIGEST = "9b503be79840b7878fe8428ad42799330e2fbdece71cdbc8d6cdf0164a6bcb17"


def pqt_digest(dev) -> str:
    """sha256 of ``per_question_topk``'s output on a fixed input made with
    numpy from seeds (D = H = 1024, G = 4, M = 512, lengths 512 / 300 / 37 /
    0, k = 100, weights with random biases and LayerNorm affines)."""
    d, g, m = 1024, 4, 512
    wr = np.random.default_rng(17)
    dense = lambda i, o: {"kernel": (wr.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                          "bias": (0.1 * wr.normal(size=o)).astype(np.float32)}
    ln = lambda n: {"scale": (1 + 0.1 * wr.normal(size=n)).astype(np.float32),
                    "bias": (0.1 * wr.normal(size=n)).astype(np.float32)}
    feats = {
        "query_proj": {"proj": dense(d, d)}, "q_gate": dense(d, d), "q_bias": dense(d, d),
        "struct_proj": dense(20, d), "struct_norm": ln(d), "struct_gate": dense(d, 1),
        "state_net_0": dense(3 * d + 1, d), "state_norm": ln(d),
        "state_net_1": dense(d, d), "score_head": dense(d, 1),
    }
    bundle = {"features": bundle_from_numpy(feats, device=dev)}
    rng = np.random.default_rng(17)
    rows = lambda: torch.as_tensor(np.tanh(rng.normal(size=(g, m, d))), dtype=torch.bfloat16, device=dev)
    q = torch.as_tensor(rng.normal(size=(g, d)), dtype=torch.float32, device=dev)
    h, r, t = rows(), rows(), rows()
    s = torch.as_tensor(rng.random((g, m, 20)), dtype=torch.bfloat16, device=dev)
    lengths = torch.as_tensor(np.array([m, 300, 37, 0], np.int32), device=dev)
    vals, ids = sk.per_question_topk(bundle, q, h, r, t, s, lengths, k=100)
    return hashlib.sha256(vals.cpu().numpy().tobytes() + ids.cpu().numpy().tobytes()).hexdigest()

"""The hand-written kernels on the card against their plain versions.

These tests need an NVIDIA GPU (the kernels have no CPU mode): they carry the
``cuda`` marker and skip without one.  They import no JAX, so they run on the
GPU machine (``--noconftest``: the repository's conftest imports JAX)::

    python -m pytest --noconftest tests/test_torch_card.py -q

Tolerance: each kernel and its plain version use bf16 operands with f32 sums
and round at the same points, so scores agree to 1e-3 absolute (O(1) scores,
f32 sums in other orders); id sets may differ only by a near-tie swap.
"""

import numpy as np
import pytest
import torch

from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.ops.query import TripleIndex
from evi_rag_tpu_torch.serving import edge_struct_features
from evi_rag_tpu_torch.testing import PQT_DIGEST, pqt_digest
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

pytestmark = pytest.mark.cuda


def _bundle(d, h, s, seed):
    rng = np.random.default_rng(seed)
    dense = lambda i, o: {"kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
                          "bias": (0.1 * rng.normal(size=o)).astype(np.float32)}
    ln = lambda n: {"scale": (1 + 0.1 * rng.normal(size=n)).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=n)).astype(np.float32)}
    feats = {
        "query_proj": {"proj": dense(d, d)}, "q_gate": dense(d, d), "q_bias": dense(d, d),
        "struct_proj": dense(s, d), "struct_norm": ln(d), "struct_gate": dense(d, 1),
        "state_net_0": dense(3 * d + 1, h), "state_norm": ln(h),
        "state_net_1": dense(h, h), "score_head": dense(h, 1),
    }
    return {"features": bundle_from_numpy(feats, device="cuda")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, g, m, d, s, lens, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = lambda: torch.tanh(torch.randn(g, m, d, device=dev, generator=gen)).to(torch.bfloat16)
    return (torch.randn(g, d, device=dev, generator=gen), rows(), rows(), rows(),
            torch.rand(g, m, s, device=dev, generator=gen).to(torch.bfloat16),
            torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("d,h,m,k", [(64, 64, 128, 20), (128, 256, 300, 16), (1024, 1024, 512, 100)])
def test_kernel_matches_plain_version(cuda, d, h, m, k):
    bundle = _bundle(d, h, 20, seed=d + h)
    lens = [m, m - 7, 5, 0]
    args = (bundle, *_inputs(cuda, len(lens), m, d, 20, lens, seed=m))
    before = sk.per_question_topk.launches
    vals, ids = sk.per_question_topk(*args, k=k)
    torch.cuda.synchronize()
    assert sk.per_question_topk.launches == before + 1
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    scores = sk.per_question_scores_reference(*args).cpu().numpy()
    v, i = vals.cpu().numpy(), ids.cpu().numpy()
    for g, n_valid in enumerate(lens):
        n = min(n_valid, k)
        assert np.isfinite(v[g, :n]).all() and np.isneginf(v[g, n:]).all()
        np.testing.assert_array_equal(i[g, n:], np.arange(n_valid, n_valid + k - n))
        if n == 0:
            continue
        got = i[g, :n]
        np.testing.assert_allclose(v[g, :n], scores[g, got], rtol=0, atol=1e-3)
        want = np.argsort(-scores[g], kind="stable")[:n]
        kth = scores[g, want[-1]]
        for e in set(got.tolist()) ^ set(want.tolist()):
            assert abs(scores[g, e] - kth) < 1e-3, (g, e)


def test_kernel_breaks_ties_by_lower_index(cuda):
    bundle = _bundle(64, 64, 20, seed=1)
    q, h, r, t, s, lengths = _inputs(cuda, 1, 128, 64, 20, [128], seed=2)
    for x in (h, r, t, s):
        x[:, 90] = x[:, 40]
        x[:, 60] = x[:, 40]
    vals, ids = sk.per_question_topk(bundle, q, h, r, t, s, lengths, k=128)
    pos = {int(e): n for n, e in enumerate(ids[0].tolist())}
    assert pos[40] < pos[60] < pos[90] and pos[90] - pos[40] == 2


def test_kernel_rejects_what_it_cannot_take(cuda):
    bundle = _bundle(64, 64, 20, seed=1)
    q, h, r, t, s, lengths = _inputs(cuda, 2, 128, 64, 20, [128, 3], seed=3)
    with pytest.raises(TypeError):
        sk.per_question_topk(bundle, q, h.float(), r, t, s, lengths, k=8)
    with pytest.raises(ValueError):
        sk.per_question_topk(bundle, q, h[:, ::2], r[:, ::2], t[:, ::2], s[:, ::2], lengths, k=8)
    with pytest.raises(ValueError):
        sk.per_question_topk(bundle, q, h, r, t, s, lengths, k=129)


def test_per_question_kernel_output_unchanged_by_the_shared_header(cuda):
    assert pqt_digest(cuda) == PQT_DIGEST


def _pooled_case(dev, b, m, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = lambda: torch.tanh(torch.randn(m, d, device=dev, generator=gen)).to(torch.bfloat16)
    index = TripleIndex(rows(), rows(), rows(),
                        torch.randn(m, 20, device=dev, generator=gen).to(torch.bfloat16))
    return torch.randn(b, d, device=dev, generator=gen), index


def _hold_topk(vals, ids, scores, k, tol):
    """Top-k of a kernel against the plain version's full score rows: values
    within tol of the plain score of the same id, sorted, and every id in one
    top-k but not the other within tol of the plain k-th score."""
    v, i, s = vals.cpu().numpy(), ids.cpu().numpy(), scores.cpu().numpy()
    for b in range(v.shape[0]):
        assert len(set(i[b].tolist())) == k and i[b].min() >= 0 and i[b].max() < s.shape[1]
        np.testing.assert_allclose(v[b], s[b, i[b]], rtol=0, atol=tol)
        assert (np.diff(v[b]) <= 0).all()
        want = np.argsort(-s[b], kind="stable")[:k]
        kth = s[b, want[-1]]
        for e in set(i[b].tolist()) ^ set(want.tolist()):
            assert abs(s[b, e] - kth) < tol, (b, e)


@pytest.mark.parametrize("d,m", [(64, 1000), (64, 4096), (1024, 1000), (1024, 4096)])
def test_pooled_kernels_match_plain_versions(cuda, d, m):
    bundle = _bundle(d, d, 20, seed=d + m)
    q, index = _pooled_case(cuda, 3, m, d, seed=m)
    args = (bundle, q, index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
    before = (sk.score_bidirectional.launches, sk.query_topk_fused.launches)
    dense = sk.score_bidirectional(*args)
    vals1, ids1 = sk.query_topk_per_query(bundle, q, index, k=20)
    vals2, ids2 = sk.query_topk_fused(bundle, q, index, k=20)
    torch.cuda.synchronize()
    assert (sk.score_bidirectional.launches, sk.query_topk_fused.launches) == (before[0] + 2, before[1] + 1)
    plain1 = sk.score_bidirectional_reference(*args)
    np.testing.assert_allclose(dense.cpu().numpy(), plain1.cpu().numpy(), rtol=0, atol=1e-3)
    _hold_topk(vals1, ids1, plain1, 20, 1e-3)
    _hold_topk(vals2, ids2, sk.fused_scores_reference(*args), 20, 1e-3)


def test_pooled_kernels_break_ties_by_lower_index(cuda):
    bundle = _bundle(64, 64, 20, seed=1)
    q, index = _pooled_case(cuda, 2, 128, 64, seed=2)
    for x in (index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw):
        x[90] = x[40]
        x[60] = x[40]
    for fn in (sk.query_topk_per_query, sk.query_topk_fused):
        _, ids = fn(bundle, q, index, k=128)
        for b in range(2):
            pos = {int(e): n for n, e in enumerate(ids[b].tolist())}
            assert pos[40] < pos[60] < pos[90] and pos[90] - pos[40] == 2


def test_pooled_kernels_reject_what_they_cannot_take(cuda):
    bundle = _bundle(64, 64, 20, seed=1)
    q, index = _pooled_case(cuda, 2, 128, 64, seed=3)
    for fn in (sk.query_topk_per_query, sk.query_topk_fused):
        with pytest.raises(ValueError):
            fn(bundle, q, index, k=129)
        with pytest.raises(TypeError):
            fn(bundle, q, index.to(dtype=torch.float32), k=8)
    with pytest.raises(TypeError):
        sk.score_bidirectional(bundle, q, index.head_repr.float(), index.rel_repr, index.tail_repr,
                               index.struct_raw)


def test_edge_struct_features_repeat_bit_for_bit(cuda):
    rng = np.random.default_rng(4)
    g, n, m = 16, 512, 2048
    ei = torch.as_tensor(rng.integers(0, n - 1, size=(g, 2, m)), device=cuda)
    lens = torch.as_tensor(rng.integers(m // 2, m + 1, size=g), device=cuda)
    mask = torch.arange(m, device=cuda)[None, :] < lens[:, None]
    ei = torch.where(mask[:, None, :], ei, torch.full_like(ei, n - 1))
    topic = torch.zeros(g, n, 2, device=cuda)
    topic[:, :3, 0] = 1.0
    topic[:, 3:-1, 1] = 1.0
    runs = [edge_struct_features(topic, ei, mask, num_rounds=2, num_reverse_rounds=2) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])

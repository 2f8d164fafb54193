"""The hand-written kernels on the card against their plain versions (also
per shard and per mesh entry: the sharded index build and pooled query, the
data-parallel serve; the pooled query axis cut into launches), serve at the
shapes the kernels refuse, the training steps and the GFlowNet's sample-then-score and "dots" remat on the
card, and the build's gte encoder and native BFS library on the card's
machine; one test (the port's task list) needs no card.

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


def _hold_per_question(vals, ids, scores, lens, k):
    """A per-question top-k against the plain version's [G, M] scores:
    min(len, k) finite values within 1e-3 of the plain score of the same id,
    -inf slots carrying the ids past the prefix, and every id in one top-k
    but not the other within 1e-3 of the plain k-th score."""
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


@pytest.mark.parametrize("length", [0, 1, 37, 127, 128, 129, "M-1", "M"])
@pytest.mark.parametrize("d,h,m,k", [(64, 64, 300, 20), (128, 256, 300, 16), (128, 200, 300, 16),
                                     (1024, 1024, 512, 100)])
def test_kernel_matches_plain_version(cuda, d, h, m, k, length):
    """Ragged prefixes (empty, inside the first tile, on and around a tile
    edge, M - 1, M) at D = H = 64 (a cluster of one CTA), H = 256, H = 200
    (W1 columns past H zero and masked) and the production width."""
    bundle = _bundle(d, h, 20, seed=d + h)
    n_valid = {"M-1": m - 1, "M": m}.get(length, length)
    lens = [n_valid, m - 7, 5, 0]
    args = (bundle, *_inputs(cuda, len(lens), m, d, 20, lens, seed=m + d))
    before = sk.per_question_topk.launches
    vals, ids = sk.per_question_topk(*args, k=k)
    torch.cuda.synchronize()
    assert sk.per_question_topk.launches == before + 1
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    _hold_per_question(vals, ids, sk.per_question_scores_reference(*args).cpu().numpy(), lens, k)


def test_kernel_repeats_bit_for_bit(cuda):
    """Two launches on the same input give the same bits (fixed f32 sum
    orders, no float atomics)."""
    bundle = _bundle(1024, 1024, 20, seed=3)
    args = (bundle, *_inputs(cuda, 6, 1024, 1024, 20, [1024, 700, 129, 37, 1, 0], seed=4))
    runs = [sk.per_question_topk(*args, k=100) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


def test_kernel_schedules_and_question_chunks_agree_bit_for_bit(cuda, monkeypatch):
    """Persistent clusters, one cluster per tile and question chunks (a
    scratch limit of 3 questions) walk the same tiles: bitwise the same
    output."""
    d, h, m = 128, 256, 300
    bundle = _bundle(d, h, 20, seed=5)
    lens = [300, 0, 129, 128, 1, 37, 299, 200]
    args = (bundle, *_inputs(cuda, len(lens), m, d, 20, lens, seed=6))
    want = sk.per_question_topk(*args, k=16)
    monkeypatch.setattr(sk, "PQT_CLUSTERS", len(lens) * 3)  # one cluster per (question, tile)
    got = sk.per_question_topk(*args, k=16)
    monkeypatch.setattr(sk, "PQT_CLUSTERS", 1)  # one cluster walks every live tile
    got1 = sk.per_question_topk(*args, k=16)
    monkeypatch.setattr(sk, "PQT_CLUSTERS", 0)
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 3 * m * sk.scratch_bytes_per_edge(d, h, False))
    assert len(sk._question_chunks(len(lens), m, sk.scratch_bytes_per_edge(d, h, False))) == 3
    got3 = sk.per_question_topk(*args, k=16)
    for other in (got, got1, got3):
        assert torch.equal(want[0], other[0]) and torch.equal(want[1], other[1])
    _hold_per_question(*want, sk.per_question_scores_reference(*args).cpu().numpy(), lens, 16)


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


def test_per_question_kernel_output_matches_its_pinned_digest(cuda):
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


@pytest.mark.parametrize("d,h,m", [(64, 64, 1000), (64, 64, 4096), (256, 256, 1000), (512, 512, 4096),
                                   (1024, 1024, 1000), (1024, 1024, 4096), (64, 1024, 1000)])
def test_pooled_kernels_match_plain_versions(cuda, d, h, m):
    bundle = _bundle(d, h, 20, seed=d + h + m)
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


def _hold_pooled(bundle, q, index, k):
    """Both pooled kernels against their plain versions (dense scores of
    kernel 1 and the top-k of both)."""
    args = (bundle, q, index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
    dense = sk.score_bidirectional(*args)
    vals2, ids2 = sk.query_topk_fused(bundle, q, index, k=k)
    torch.cuda.synchronize()
    plain1 = sk.score_bidirectional_reference(*args)
    np.testing.assert_allclose(dense.cpu().numpy(), plain1.cpu().numpy(), rtol=0, atol=1e-3)
    vals1, ids1 = sk.query_topk_per_query(bundle, q, index, k=k)
    _hold_topk(vals1, ids1, plain1, k, 1e-3)
    _hold_topk(vals2, ids2, sk.fused_scores_reference(*args), k, 1e-3)


@pytest.mark.parametrize("m", [1, 63, 65, 1000, 4096])
@pytest.mark.parametrize("b", [1, 3, 130])
def test_pooled_kernels_ragged_shapes(cuda, m, b):
    """Ragged candidate tiles (M not a multiple of 128) and query groups (B
    not a multiple of 8) are masked, never read past."""
    bundle = _bundle(128, 256, 20, seed=m + b)
    q, index = _pooled_case(cuda, b, m, 128, seed=7 * m + b)
    _hold_pooled(bundle, q, index, min(m, 10))


@pytest.mark.parametrize("b", [1, 8, 9, 16, 33, 128])
def test_fused_kernel_query_groups_at_production_width(cuda, b):
    """Kernel 2 at D = H = 1024 with B queries over M = 4,096 + 77 candidates
    (a ragged last tile): a CTA's consumer warpgroups walk one query between
    them, an odd or even number, whole groups of 32, or a group and a ragged
    one; one launch a call, the top-k held to the plain version."""
    d = h = 1024
    bundle = _bundle(d, h, 20, seed=b)
    q, index = _pooled_case(cuda, b, 4096 + 77, d, seed=100 + b)
    before = sk.query_topk_fused.launches
    vals, ids = sk.query_topk_fused(bundle, q, index, k=20)
    torch.cuda.synchronize()
    assert sk.query_topk_fused.launches == before + 1
    args = (bundle, q, index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
    _hold_topk(vals, ids, sk.fused_scores_reference(*args), 20, 1e-3)


def test_pooled_kernels_chunk_the_scratch(cuda, monkeypatch):
    """A scratch limit below the call's need splits M into chunks (of 256
    candidates here) with the same results."""
    d = h = 256
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 300 * sk.scratch_bytes_per_edge(d, h, True))
    assert len(sk._edge_chunks(1000, sk.scratch_bytes_per_edge(d, h, True))) == 4
    bundle = _bundle(d, h, 20, seed=9)
    q, index = _pooled_case(cuda, 5, 1000, d, seed=9)
    _hold_pooled(bundle, q, index, 20)


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


def test_pooled_kernels_chunk_the_query_axis(cuda):
    """70,000 queries, past one launch's 65,535: two launches of each pooled
    kernel, and the joined rows at both sides of the cut and at the ends
    held to the plain versions."""
    bundle = _bundle(256, 256, 20, seed=70)
    q, index = _pooled_case(cuda, 70_000, 1024, 256, seed=70)
    before = (sk.score_bidirectional.launches, sk.query_topk_fused.launches)
    vals1, ids1 = sk.query_topk_per_query(bundle, q, index, k=20)
    vals2, ids2 = sk.query_topk_fused(bundle, q, index, k=20)
    torch.cuda.synchronize()
    assert (sk.score_bidirectional.launches, sk.query_topk_fused.launches) == (before[0] + 2, before[1] + 2)
    assert vals1.shape == vals2.shape == (70_000, 20)
    rows = torch.tensor([0, 1, 65533, 65534, 65535, 65536, 69998, 69999], device=cuda)
    args = (bundle, q[rows], index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
    _hold_topk(vals1[rows], ids1[rows], sk.score_bidirectional_reference(*args), 20, 1e-3)
    _hold_topk(vals2[rows], ids2[rows], sk.fused_scores_reference(*args), 20, 1e-3)


def _route_bundle(emb, rounds, seed):
    """A flax-initialised retriever bundle with ``rounds`` DDE rounds each
    way (struct width 4 (1 + 2 rounds)), on the card."""
    from evi_rag_tpu_torch.models.retriever import Retriever, init_parameters, params_to_numpy
    from evi_rag_tpu_torch.train.checkpoint import export_retriever_features

    model = Retriever(emb_dim=emb, hidden_dim=128, dde_rounds=rounds, dde_reverse_rounds=rounds)
    init_parameters(model, torch.Generator().manual_seed(seed))
    exported = export_retriever_features(params_to_numpy(model)["params"], model.parity_meta())
    return {"features": bundle_from_numpy(exported["features"], device="cuda")}


@pytest.mark.parametrize("emb,rounds,k,routed", [(96, 2, 20, True), (64, 4, 20, True), (64, 2, 1500, True),
                                                 (64, 2, 20, False)], ids=["emb96", "s36", "k1500", "supported"])
def test_serve_routes_shapes_the_kernel_refuses(cuda, emb, rounds, k, routed):
    """emb_dim 96, S = 36 and k = 1500: no kernel-3 launch, and the serve
    equals the plain serve (every bucket on the plain bf16 scorer) bit for
    bit; a shape the kernel takes still launches it."""
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.serving import serve_split

    ds = make_synthetic_dataset(num_samples=24, emb_dim=emb, max_nodes=64, seed=5)
    bundle = _route_bundle(emb, rounds, seed=5)
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb, k=k,
              num_rounds=rounds, num_reverse_rounds=rounds, group_size=8, device=cuda)
    before = sk.per_question_topk.launches
    served, _ = serve_split(bundle, ds.samples, fused_threshold=32, **kw)
    assert (sk.per_question_topk.launches == before) is routed
    if not routed:
        return
    plain, _ = serve_split(bundle, ds.samples, fused_threshold=1 << 30, **kw)
    for a, b, smp in zip(served, plain, ds.samples):
        assert a.sample_id == b.sample_id == smp.sample_id
        assert a.edge_ids.size == min(k, smp.edge_index.shape[1])
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


@pytest.mark.parametrize("entries", [1, 4])
def test_sharded_index_build_on_the_card(cuda, entries):
    """``build_triple_index_sharded`` over ``entries`` shards of one card
    against ``build_triple_index`` (rtol 1e-5 / atol 1e-6,
    ``tests/test_sharded.py:236-238``)."""
    from evi_rag_tpu_torch.ops.query import build_triple_index, build_triple_index_sharded
    from evi_rag_tpu_torch.parallel.mesh import make_mesh
    from evi_rag_tpu_torch.testing import random_bundle

    v, r, m, d = 4096, 64, 2048, 128
    bundle = {"features": bundle_from_numpy(random_bundle(d, seed=3)["features"], device=cuda)}
    gen = torch.Generator(device=cuda).manual_seed(3)
    tables = dict(entity_emb=torch.randn(v, d, device=cuda, generator=gen),
                  relation_emb=torch.randn(r, d, device=cuda, generator=gen),
                  nontext_mask=torch.rand(v, device=cuda, generator=gen) < 0.1,
                  heads=torch.randint(0, v, (m,), device=cuda, generator=gen),
                  rels=torch.randint(0, r, (m,), device=cuda, generator=gen),
                  tails=torch.randint(0, v, (m,), device=cuda, generator=gen),
                  struct_raw=torch.randn(m, 20, device=cuda, generator=gen))
    want = build_triple_index(bundle, **tables, device=cuda)
    got = build_triple_index_sharded(bundle, mesh=make_mesh(devices=[cuda] * entries), **tables)
    for name in ("head_repr", "rel_repr", "tail_repr", "struct_raw"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(), getattr(want, name).cpu().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_sharded_fused_query_on_the_card(cuda):
    """``query_topk_sharded_fused`` over 4 shards of one card launches kernel
    2 once per shard and gives the unsharded kernel's top-k (per-candidate
    scores do not depend on the shard), held to the plain version."""
    from evi_rag_tpu_torch.ops.query import query_topk_sharded_fused
    from evi_rag_tpu_torch.parallel.mesh import make_mesh

    d = 128
    bundle = _bundle(d, d, 20, seed=21)
    q, index = _pooled_case(cuda, 5, 4096, d, seed=21)
    before = sk.query_topk_fused.launches
    vals, ids = query_topk_sharded_fused(bundle, q, index, mesh=make_mesh(devices=[cuda] * 4), k=20)
    torch.cuda.synchronize()
    assert sk.query_topk_fused.launches == before + 4
    uvals, uids = sk.query_topk_fused(bundle, q, index, k=20)
    np.testing.assert_allclose(vals.cpu().numpy(), uvals.cpu().numpy(), rtol=0, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(ids.tolist(), uids.tolist()))
    args = (bundle, q, index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
    _hold_topk(vals, ids, sk.fused_scores_reference(*args), 20, 1e-3)


def test_data_parallel_serve_on_the_card(cuda):
    """``serve_split`` over two mesh entries of one card: kernel 3 runs on
    each entry (twice the launches of the single-device serve) and every
    question gets the single-device serve's ids and scores."""
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.parallel.mesh import make_mesh
    from evi_rag_tpu_torch.serving import serve_split
    from evi_rag_tpu_torch.testing import random_bundle

    ds = make_synthetic_dataset(num_samples=40, emb_dim=64, max_nodes=64, seed=5)
    bundle = {"features": bundle_from_numpy(random_bundle(64, seed=5)["features"], device=cuda)}
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb, k=20,
              num_rounds=2, num_reverse_rounds=2, fused_threshold=32, group_size=8)
    before = sk.per_question_topk.launches
    single, stats = serve_split(bundle, ds.samples, device=cuda, **kw)
    mid = sk.per_question_topk.launches
    dp, dp_stats = serve_split(bundle, ds.samples, mesh=make_mesh(devices=[cuda] * 2), **kw)
    assert mid - before == stats.num_groups + 1 and dp_stats.num_groups == stats.num_groups
    assert sk.per_question_topk.launches - mid == 2 * (stats.num_groups + 1)
    for a, b in zip(single, dp):
        assert a.sample_id == b.sample_id
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


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


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One f32 train step at D = H = 256 with 4 questions (TF32 off): loss
    within rtol 1e-5, every gradient leaf within atol 1e-5 + rtol 1e-3, and
    AdamW applied to the CPU's gradients gives parameters within 1e-6 on
    both devices; one bf16 step at D = H = 1024 is finite."""
    from evi_rag_tpu_torch.testing import bf16_card_step, card_vs_cpu_step

    res = card_vs_cpu_step()
    assert res["loss_rel"] <= 1e-5, res
    assert res["grad_ratio"] <= 1.0, res
    assert res["param_diff"] <= 1e-6, res
    bf = bf16_card_step()
    assert np.isfinite(bf["loss"]) and np.isfinite(bf["grad_norm"]) and bf["grads_finite"], bf


@pytest.mark.parametrize("width", [1024, None])
def test_segment_sum_at_the_train_bucket_repeats_and_matches_the_cpu(cuda, width):
    """``segment_sum`` of [131,072, 1,024] f32 rows over 17 segments, the
    last the padding graph's ~102k rows (the backward of a gathered [E, D]
    row in the training bucket), ids shuffled: the card repeats bit for bit
    and gives the CPU's bits, as both add each chunk's rows, then each
    segment's chunk sums, one after another.  1-D data (the loss's sums)
    repeats too, but the card adds a 1-D chunk in a tree (CUB's segmented
    reduce), so its last bits differ from the CPU's."""
    from evi_rag_tpu_torch.ops.segment import segment_sum

    gen = torch.Generator().manual_seed(11)
    e, g = 131_072, 17
    real = torch.randint(1_500, 2_100, (g - 1,), generator=gen)
    ids = torch.repeat_interleave(torch.arange(g), torch.cat([real, (e - real.sum()).reshape(1)]))
    ids = ids[torch.randperm(e, generator=gen)]
    x = torch.randn((e, width) if width else (e,), generator=gen)
    runs = [segment_sum(x.to(cuda), ids.to(cuda), g) for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    if width:
        assert torch.equal(runs[0].cpu(), segment_sum(x, ids, g))
    else:
        torch.testing.assert_close(runs[0].cpu(), segment_sum(x, ids, g), rtol=1e-5, atol=1e-4)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps of the larger of |a|, |b| and 1/32 of b's RMS:
    below that floor two f32 sums of thousands of terms that cancel may
    differ by more than a bf16 ulp of their small result."""
    a, b = a.double(), b.double()
    scale = torch.maximum(torch.maximum(a.abs(), b.abs()), b.pow(2).mean().sqrt() / 32)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(scale)) - 7)


def test_dense_split_tensor_core_route_matches_the_f32_route(cuda):
    """``dense_split`` at bf16 on the card (``DenseSplitBF16``: bf16 GEMMs
    that write f32) against ``dense_split_f32`` (f32 GEMMs of the cast
    operands, TF32 off) at production width: parts 1,024 / 1,024 / 1,024 /
    1, H = 1,024, 8,192 rows.  The output and the gradients of every part
    and of each kernel slice agree within one bf16 ulp (``_bf16_ulps``),
    at least 99% of each equal; the bias's f32 gradient within f32
    rounding."""
    from evi_rag_tpu_torch.ops import nnfn

    gen = torch.Generator(device=cuda).manual_seed(21)
    d, h, e = 1024, 1024, 8192
    kernel = torch.randn(3 * d + 1, h, device=cuda, generator=gen) / np.sqrt(3 * d + 1)
    bias = 0.1 * torch.randn(h, device=cuda, generator=gen)
    parts = tuple(torch.tanh(torch.randn(e, w, device=cuda, generator=gen)).to(torch.bfloat16) for w in (d, d, d))
    parts += (-torch.rand(e, 1, device=cuda, generator=gen).mul(40).to(torch.bfloat16),)
    w = torch.randn(e, h, device=cuda, generator=gen)

    def run(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in (kernel, bias, *parts)]
        out = fn({"kernel": leaves[0], "bias": leaves[1]}, tuple(leaves[2:]), torch.bfloat16)
        out_grads = torch.autograd.grad((out.float() * w).sum(), leaves)
        named = {"out": out.detach(), "bias": out_grads[1]}
        named.update({f"kernel{i}": k for i, k in enumerate(out_grads[0].split([d, d, d, 1]))})
        named.update({f"part{i}": g for i, g in enumerate(out_grads[2:])})
        return named

    got, want = run(nnfn.dense_split), run(nnfn.dense_split_f32)
    assert got["out"].dtype == torch.bfloat16
    for name, b in want.items():
        a = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "bias":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            continue
        ulps, equal = float(_bf16_ulps(a, b).max()), float((a == b).float().mean())
        assert ulps <= 1.0 and equal >= 0.99, (name, ulps, equal)


def test_bf16_train_step_takes_the_tensor_core_route(cuda):
    """While a profiler session runs, one bf16 ``loss_and_grads`` step
    (bidirectional, D = H = 1,024) counts ``nnfn.dense_split.tc`` twice, one
    a direction (the backward adds none), and ``nnfn.dense_split.f32``
    never."""
    from torch.profiler import ProfilerActivity, profile

    from evi_rag_tpu_torch.testing import bf16_card_step
    from evi_rag_tpu_torch.utils import profiling

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        bf = bf16_card_step()
    counters = profiling.totals()["counters"]
    profiling.reset()
    assert counters.get("nnfn.dense_split.tc") == 2 and "nnfn.dense_split.f32" not in counters, counters
    assert np.isfinite(bf["loss"]) and bf["grads_finite"], bf


def test_gflownet_step_on_the_card_matches_the_cpu(cuda):
    """One f32 GFlowNet train step at H = 64 (4 rollouts, the same Gumbel
    uniforms, dropout 0, TF32 off) from perturbed parameters, so that every
    leaf has a non-zero gradient: loss within rtol 1e-5, every gradient
    leaf within atol 1e-5 + rtol 1e-3, and AdamW on the CPU's gradients
    gives parameters within 1e-6 on both devices."""
    from evi_rag_tpu_torch.testing import gfn_card_vs_cpu_step

    res = gfn_card_vs_cpu_step()
    assert res["zero_grad_leaves"] == [], res
    assert res["loss_rel"] <= 1e-5, res
    assert res["grad_ratio"] <= 1.0, res
    assert res["param_diff"] <= 1e-6, res


def _gfn_small(dev, hidden=64, dropout=0.1, seed=0):
    """(cfg, modules with perturbed parameters, bundle, batch, draws) of a
    small GFlowNet step on ``dev`` (4 graphs, 2 rollouts, BC on)."""
    from evi_rag_tpu_torch.models.batches import replicate_agent_batch
    from evi_rag_tpu_torch.models.gflownet.actor import make_rollout_draws
    from evi_rag_tpu_torch.ops.graph import batch_to
    from evi_rag_tpu_torch.testing import agent_inputs, random_bundle
    from evi_rag_tpu_torch.train import gflownet_trainer as gt

    cfg = gt.GFlowNetConfig(hidden_dim=hidden, max_steps=3, num_train_rollouts=2, bc_weight=0.5, dropout=dropout)
    batch = batch_to(agent_inputs(hidden, 4, seed), dev)
    modules = gt.build_modules(cfg)
    gt.init_gflownet_params(cfg, modules, seed=seed, device=dev)
    noise = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():
        for _, p in modules.named_parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=noise).to(dev))
    draws = make_rollout_draws(cfg.actor, replicate_agent_batch(batch, 2), hidden_dim=hidden, dropout=dropout,
                               train=True, sample=True, generator=torch.Generator(device=dev).manual_seed(seed))
    return cfg, modules, gt.bundle_on(random_bundle(hidden, seed), dev), batch, draws


def test_sample_then_score_matches_the_canonical_loop_on_the_card(cuda):
    """The two-pass rollout against the step loop at H = 64 (dropout 0.1,
    the same draws): actions equal (or a near tie), log-probs, state
    embeddings and BC statistics within rtol 1e-4 / atol 1e-5, the loss
    within rtol 1e-3 / atol 1e-4 (``testing.sts_vs_canonical``)."""
    from evi_rag_tpu_torch.testing import sts_vs_canonical

    res = sts_vs_canonical(*_gfn_small(cuda))
    assert all(d["near_tie"] for d in res["differing"]) and len(res["differing"]) <= 1, res
    assert max(res["ratios"].values()) <= 1.0 and res["loss_ratio"] <= 1.0, res
    assert res["acting_steps"] > 0


@pytest.mark.parametrize("sts", [False, True], ids=["canonical", "sts"])
def test_dots_remat_gradients_match_no_remat_on_the_card(cuda, sts):
    """``remat_policy="dots"`` on the card: the same loss bit for bit and
    gradients within rtol 1e-4 / atol 1e-6 of the step without remat."""
    import dataclasses

    from evi_rag_tpu_torch.train import gflownet_trainer as gt

    cfg, modules, bundle, batch, draws = _gfn_small(cuda)
    out = []
    for remat in (False, "dots"):
        c = dataclasses.replace(cfg, sample_then_score=sts, remat_policy=remat)
        modules.zero_grad(set_to_none=True)
        loss, _ = gt.rollout_losses(modules, bundle, batch, c, num_rollouts=2, bc_weight=0.5, temperature=1.0,
                                    train=True, draws=draws)
        loss.backward()
        out.append((loss.item(), {n: p.grad.detach().clone() for n, p in modules.named_parameters()
                                  if p.grad is not None}))
    assert out[1][0] == out[0][0]
    assert out[0][1].keys() == out[1][1].keys() and out[0][1]
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, rtol=1e-4, atol=1e-6, msg=name)


def test_profiling_hooks_on_the_card(cuda, tmp_path):
    """``device_memory_stats`` gives JAX's byte keys from the allocator;
    ``trace`` records the card's kernels inside an ``annotate`` range (with
    its NVTX range)."""
    from evi_rag_tpu_torch.utils.profiling import annotate, device_memory_stats, trace

    x = torch.ones(1024, 1024, device=cuda)
    stats = device_memory_stats(cuda)
    assert stats["bytes_in_use"] >= x.numel() * 4 and stats["peak_bytes_in_use"] >= stats["bytes_in_use"]
    with trace(tmp_path) as prof:
        with annotate("card_span"):
            (x @ x).sum().item()
    assert (tmp_path / "trace.json").exists()
    assert any(e.key == "card_span" for e in prof.key_averages())


def test_port_runs_every_task_of_the_jax_cli():
    """The port's ``TASKS`` has exactly the JAX package's ten task names
    (read from ``evi_rag_tpu/cli.py``'s source: the card's machine has no
    JAX to import it)."""
    import ast
    import pathlib

    from evi_rag_tpu_torch.cli import TASKS

    tree = ast.parse((pathlib.Path(__file__).resolve().parents[1] / "evi_rag_tpu" / "cli.py").read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.AnnAssign) and getattr(n.target, "id", None) == "TASKS"]
    jax_tasks = [ast.literal_eval(k) for k in node.value.keys]
    assert len(jax_tasks) == 10
    assert sorted(TASKS) == sorted(jax_tasks)


def test_gte_on_the_card_matches_the_cpu(cuda):
    """A small gte (4 layers, hidden 256, 4 heads, intermediate 512) with
    seeded weights, f32 with TF32 off: the pooled outputs of ragged rows
    (one [CLS] [SEP] only) on the card within min cosine 0.99999 and max abs
    error 1e-4 x max |x| of the CPU's, and ``encode`` through the stand-in
    tokenizer the same on both devices."""
    from evi_rag_tpu_torch.data.gte import GTEConfig, GTEModel, GTETextEncoder, mean_pool
    from evi_rag_tpu_torch.testing import HashTokenizer, random_gte_state

    cfg = GTEConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
                    intermediate_size=512)
    state = random_gte_state(cfg, seed=4)
    models = {dev: GTEModel.from_state_dict(state, cfg, device=dev) for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(4)
    ids = rng.integers(5, cfg.vocab_size, size=(6, 32))
    mask = np.zeros((6, 32), np.int64)
    for row, n in enumerate((32, 20, 9, 5, 3, 2)):
        mask[row, :n] = 1
    pooled = {}
    for dev, model in models.items():
        i, m = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
        with torch.inference_mode():
            pooled[dev] = mean_pool(model(i, m), m).cpu().double().numpy()
    a, b = pooled["cpu"], pooled["cuda"]
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.99999 and np.abs(a - b).max() <= 1e-4 * np.abs(a).max()
    texts = ["Entity 12 Film", "people.person.place_of_birth", "what is the capital of france", ""]
    enc = {dev: GTETextEncoder.from_model(m, HashTokenizer(cfg.vocab_size), max_length=16) for dev, m in models.items()}
    got = {dev: e.encode(texts, batch_size=8) for dev, e in enc.items()}
    np.testing.assert_allclose(got["cuda"], got["cpu"], rtol=1e-4, atol=1e-4 * np.abs(got["cpu"]).max())


def test_native_graphcore_builds_here_and_matches_numpy(cuda, tmp_path, monkeypatch):
    """``csrc/graphcore.cpp`` built with g++ on this machine (into an empty
    build directory) and held to the numpy engine on random graphs."""
    from evi_rag_tpu_torch.data import bfs_label, native
    from evi_rag_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    assert native.load_library() is not None, _build.BUILD_LOG.get(native.SOURCE)
    assert _build.host_library_path(native.SOURCE).exists()
    rng = np.random.default_rng(42)
    for mode in ("undirected", "qa_directed"):
        for _ in range(6):
            src, dst = rng.integers(0, 40, size=120), rng.integers(0, 40, size=120)
            case = dict(num_nodes=40, edge_src=src, edge_dst=dst, sources=rng.integers(0, 40, size=2),
                        targets=rng.integers(0, 40, size=3))
            want = bfs_label.shortest_path_union_by_pair(path_mode=mode, **case)
            got = native.shortest_path_union_by_pair_native(path_mode=mode, **case)
            np.testing.assert_array_equal(got[0], want[0])
            assert list(got[1:]) == list(want[1:])

"""The Hopper kernel's wrapper and plain version (``ops/score_kernels.py``).

On the CPU the wrapper takes the plain version, which is held here against
JAX: the XLA path (``query_topk_per_question``, exact GELU) and the Pallas
kernel in interpret mode (tanh GELU).  Both round bf16 at other points than
the port, so the rule is set overlap: at most ``slack`` ids differ and the
scores of shared ids agree within ``atol + rtol*|s|``.  Against the XLA path:
slack 1, 0.01 + 1% (as ``tests/test_serving_parity.py``).  Against Pallas:
slack 2, 0.02 + 2%, the extra room being the tanh-vs-erf GELU gap (~1e-3 per
activation, two GELU layers per direction).

The kernel itself runs only on a card: ``tests/test_torch_card.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_inputs, make_bundle
from evi_rag_tpu.ops.nnfn import dense as j_dense
from evi_rag_tpu.ops.pallas_score import _prep_weights as j_prep, pallas_per_question_topk
from evi_rag_tpu.ops.query import query_topk_per_question as j_topk
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.ops.nnfn import dense as t_dense
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

D, H, S, G, M, K = 128, 128, 20, 3, 256, 20


@pytest.fixture(scope="module")
def case():
    np_bundle = make_bundle(D, H, S, seed=1)
    ins = build_inputs(G * M, D, S, batch=G, seed=1)
    shape = lambda a: a.reshape(G, M, -1)
    lengths = np.array([M, M - 100, 5], np.int32)
    arrays = dict(q=ins["q"], h=shape(ins["head"]), r=shape(ins["rel"]),
                  t=shape(ins["tail"]), s=shape(ins["struct"]), lengths=lengths,
                  mask=np.arange(M)[None, :] < lengths[:, None])
    jb = jax.tree.map(jnp.asarray, np_bundle)
    tb = {"features": bundle_from_numpy(np_bundle["features"], device="cpu")}
    return jb, tb, arrays


def _plain(tb, a, k=K, lengths=None):
    lens = a["lengths"] if lengths is None else lengths
    args = [torch.as_tensor(a[n]) for n in ("q", "h", "r", "t", "s")]
    v, i = sk.per_question_topk(tb, *args, torch.as_tensor(lens), k=k)
    return v.numpy(), i.numpy()


def _assert_overlap(ref_v, ref_i, got_v, got_i, *, slack, atol, rtol):
    for g in range(ref_v.shape[0]):
        ref = {int(e): float(v) for e, v in zip(ref_i[g], ref_v[g]) if np.isfinite(v)}
        got = {int(e): float(v) for e, v in zip(got_i[g], got_v[g]) if np.isfinite(v)}
        assert len(ref) == len(got), g
        common = set(ref) & set(got)
        assert len(common) >= len(ref) - slack, (g, set(ref) ^ set(got))
        for e in common:
            assert abs(ref[e] - got[e]) < atol + rtol * abs(ref[e]), (g, e, ref[e], got[e])


def test_prep_weights_fold_is_exact(case):
    """score_head(state_net_1(z)) == z @ w2s + b2s in f32, and the port's
    split matches ``_prep_weights``."""
    jb, tb, _ = case
    w = sk.prep_weights(tb["features"])
    z = np.random.default_rng(0).normal(size=(64, H)).astype(np.float32)
    zt = torch.as_tensor(z)
    ref = t_dense(tb["features"]["score_head"], t_dense(tb["features"]["state_net_1"], zt))[:, 0]
    got = zt @ w["w2s"][:, 0] + w["b2s"][0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    jw = j_prep(jb["features"])
    want_j = j_dense(jb["features"]["score_head"], j_dense(jb["features"]["state_net_1"], jnp.asarray(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_j)[:, 0], rtol=1e-5, atol=1e-5)
    for key in ("w1_inter", "w1_struct", "w1_err"):
        np.testing.assert_array_equal(w[key].float().numpy(), np.asarray(jw[key].astype(jnp.float32)))
    for key in ("w1_dist", "b1", "w2s", "b2s", "bs", "wg_kernel"):
        np.testing.assert_allclose(w[key].numpy(), np.asarray(jw[key]), rtol=1e-6, atol=1e-6)
    # Kernel layout: W1[:3D] only as the wgmma tile image (no mma.sync layout).
    assert "w1t" not in w
    assert torch.equal(w["w1_tiles"], sk.w1_tiles(torch.cat([w["w1_inter"], w["w1_struct"], w["w1_err"]])))
    assert w["w1_tiles"].shape == (-(-H // sk.SLICE_N), 3 * D // sk.TILE_K, sk.SLICE_N, sk.TILE_K)


def test_plain_version_matches_xla_path(case):
    jb, tb, a = case
    jv, ji = j_topk(jb, *(jnp.asarray(a[n]) for n in ("q", "h", "r", "t", "s", "mask")),
                    k=K, dtype=jnp.bfloat16)
    tv, ti = _plain(tb, a)
    _assert_overlap(np.asarray(jv), np.asarray(ji), tv, ti, slack=1, atol=0.01, rtol=0.01)


def test_plain_version_matches_pallas_interpret(case):
    jb, tb, a = case
    jv, ji = pallas_per_question_topk(
        jb, *(jnp.asarray(a[n]) for n in ("q", "h", "r", "t", "s", "mask")),
        k=K, tile=128, interpret=True,
    )
    tv, ti = _plain(tb, a)
    _assert_overlap(np.asarray(jv), np.asarray(ji), tv, ti, slack=2, atol=0.02, rtol=0.02)


def test_lengths_below_k_and_zero_length(case):
    _, tb, a = case
    lens = np.array([3, 0, 5], np.int32)
    v, i = _plain(tb, a, k=K, lengths=lens)
    assert i.dtype == np.int32 and v.dtype == np.float32
    for g, n in enumerate(lens):
        assert np.isfinite(v[g, :n]).all()
        assert np.isneginf(v[g, n:]).all()
        assert (i[g, :n] < n).all()
        np.testing.assert_array_equal(i[g, n:], np.arange(n, n + K - n))
    assert (np.diff(v[0, :3]) <= 0).all()


def test_plain_scores_match_topk(case):
    """The top-k is the stable (score desc, index asc) head of the scores."""
    _, tb, a = case
    args = [torch.as_tensor(a[n]) for n in ("q", "h", "r", "t", "s", "lengths")]
    scores = sk.per_question_scores_reference(tb, *args).numpy()
    v, i = _plain(tb, a)
    for g in range(G):
        want = np.argsort(-scores[g], kind="stable")[:K]
        np.testing.assert_array_equal(i[g], want)
        np.testing.assert_array_equal(v[g], scores[g][want])


def test_cpu_wrapper_takes_plain_version_without_counting(case):
    _, tb, a = case
    before = sk.per_question_topk.launches
    v1, i1 = _plain(tb, a)
    args = [torch.as_tensor(a[n]) for n in ("q", "h", "r", "t", "s", "lengths")]
    v2, i2 = sk.per_question_topk_reference(tb, *args, k=K)
    np.testing.assert_array_equal(i1, i2.numpy())
    np.testing.assert_array_equal(v1, v2.numpy())
    assert sk.per_question_topk.launches == before


def test_wrapper_rejects_other_devices(case):
    _, tb, a = case
    meta = [torch.empty(x.shape, device="meta") for x in (a["q"], a["h"], a["r"], a["t"], a["s"])]
    with pytest.raises(ValueError, match="cuda or cpu"):
        sk.per_question_topk(tb, *meta, torch.empty(G, device="meta"), k=K)


def test_launches_enter_the_device_context_of_their_input(monkeypatch):
    """A launch runs with its tensors' device as the current device (a
    shard on ``cuda:1`` must not launch on ``cuda:0``): the C entry is called
    inside ``torch.cuda.device(<the input's device>)``.  With a stand-in
    library and device context, on ``meta`` tensors (no card here)."""
    import ctypes

    current = []

    class Context:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    seen = []

    class Library:
        def sb_select(self, *args):
            seen.append(list(current))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Context)
    monkeypatch.setattr(sk, "_lib", lambda source: Library())
    monkeypatch.setattr(sk, "_stream", lambda dev: ctypes.c_void_p(0))
    sk._launch(sk.SCORE_SOURCE, "sb_select", "select", torch.device("cuda", 1))
    sk._select(torch.empty(2, 8, device="meta"), 4, "select")
    assert seen == [[torch.device("cuda", 1)], [torch.device("meta")]] and not current

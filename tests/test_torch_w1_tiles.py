"""The pooled kernels' host-side layouts (``ops/score_kernels.py``).

``w1_tiles`` lays ``W1[:3D]`` out as the shared-memory image of K-major,
128-byte-swizzle wgmma B tiles; the kernels copy each tile as bytes, so the
layout is all there is to check here, element for element, against a numpy
version of the address formula.  ``sc_image`` is the per-question kernel's
struct scratch as its pre-pass writes it on the card (the A-chunk images
that one bulk copy moves into a slot), checked the same way.  The candidate
chunking (pooled kernels) and the question chunking (per-question kernel)
that bound the kernels' scratch are plain Python and are checked here too.  The kernels
themselves run only on a card: ``tests/test_torch_card.py``.
"""

import numpy as np
import pytest
import torch

from evi_rag_tpu_torch.ops import score_kernels as sk

WIDTHS = [(64, 64), (128, 256), (512, 512), (1024, 1024)]


def _w1(d, h, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=(3 * d, h)).astype(np.float32)).to(torch.bfloat16)


def _tile_offsets(kk, h, slice_n):
    """Flat offset in the tile image of W1[k, n] for every (k, n): tile
    (n // slice_n, k // 64), row n % slice_n of 64 k, 16-byte unit
    (k % 64) // 8 stored at unit ((k % 64) // 8) ^ (row % 8)."""
    k = np.arange(kk)[:, None]
    n = np.arange(h)[None, :]
    row = n % slice_n
    tile = (n // slice_n) * (kk // 64) + k // 64
    unit = ((k % 64) // 8) ^ (row % 8)
    return (tile * slice_n + row) * 64 + unit * 8 + k % 8


@pytest.mark.parametrize("slice_n", [64, sk.SLICE_N, 256])
@pytest.mark.parametrize("d,h", WIDTHS)
def test_w1_tiles_follow_the_swizzle_formula(d, h, slice_n):
    w1 = _w1(d, h, seed=d + h)
    tiles = sk.w1_tiles(w1, slice_n)
    ch = -(-h // slice_n)
    assert tiles.shape == (ch, 3 * d // 64, slice_n, 64) and tiles.dtype == torch.bfloat16
    assert tiles.is_contiguous()
    flat = tiles.reshape(-1).float().numpy()
    want = np.zeros(flat.size, np.float32)
    want[_tile_offsets(3 * d, h, slice_n)] = w1.float().numpy()
    np.testing.assert_array_equal(flat, want)  # columns past H are zero


@pytest.mark.parametrize("d,h", WIDTHS + [(64, 200)])
def test_w1_tiles_round_trip(d, h):
    """Inverting the swizzle and the tiling gives W1[:3D] back, bit for bit."""
    w1 = _w1(d, h, seed=3 * d + h)
    tiles = sk.w1_tiles(w1).float().numpy()
    ch, kc, n, _ = tiles.shape
    unit = np.arange(8)[None, :] ^ (np.arange(n)[:, None] % 8)  # stored unit of logical unit j
    logical = np.take_along_axis(tiles.reshape(ch, kc, n, 8, 8), unit[None, None, :, :, None], axis=3)
    back = logical.reshape(ch, kc, n, 64).transpose(1, 3, 0, 2).reshape(kc * 64, ch * n)
    np.testing.assert_array_equal(back[:, :h], w1.float().numpy())
    assert not back[:, h:].any()


def test_prep_weights_carries_the_tile_image():
    rng = np.random.default_rng(0)
    d, h, s = 128, 192, 20
    dense = lambda i, o: {"kernel": torch.as_tensor(rng.normal(size=(i, o)).astype(np.float32)),
                          "bias": torch.zeros(o)}
    ln = lambda n: {"scale": torch.ones(n), "bias": torch.zeros(n)}
    feats = {"q_gate": dense(d, d), "struct_proj": dense(s, d), "struct_norm": ln(d),
             "struct_gate": dense(d, 1), "state_net_0": dense(3 * d + 1, h), "state_norm": ln(h),
             "state_net_1": dense(h, h), "score_head": dense(h, 1)}
    w = sk.prep_weights(feats)
    w1cat = torch.cat([w["w1_inter"], w["w1_struct"], w["w1_err"]])
    assert torch.equal(w["w1_tiles"], sk.w1_tiles(w1cat))
    assert w["w1_tiles"].shape == (2, 3 * d // 64, sk.SLICE_N, 64)


def test_w1_tiles_reject_rows_off_the_tile_depth():
    with pytest.raises(ValueError):
        sk.w1_tiles(torch.zeros(3 * 40, 64, dtype=torch.bfloat16))


def test_scratch_bytes_per_edge_at_production_width():
    assert sk.scratch_bytes_per_edge(1024, 1024, False) == 4096 + 8           # sc + nav
    assert sk.scratch_bytes_per_edge(1024, 1024, True) == 4096 + 8 + 8192    # + c


@pytest.mark.parametrize("m,fused", [(1, True), (131072, False), (131072, True), (1 << 20, True),
                                     (1000, True)])
def test_edge_chunks_cover_m_within_the_scratch_limit(m, fused):
    """Chunks tile [0, M) in order, in multiples of 128 candidates (the last
    one ragged), and each stays within SCRATCH_BYTES: bench.py's 1M-candidate
    fused shape asks for at most 1 GiB, not 12 GiB."""
    per_edge = sk.scratch_bytes_per_edge(1024, 1024, fused)
    chunks = sk._edge_chunks(m, per_edge)
    assert chunks[0][0] == 0 and chunks[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all((c1 - c0) % 128 == 0 for c0, c1 in chunks[:-1])
    assert max(c1 - c0 for c0, c1 in chunks) * per_edge <= sk.SCRATCH_BYTES
    if m == 131072:
        assert len(chunks) == (1 if not fused else 2)


def test_edge_chunks_follow_the_limit(monkeypatch):
    per_edge = sk.scratch_bytes_per_edge(256, 256, True)
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 300 * per_edge)
    assert sk._edge_chunks(1000, per_edge) == [(0, 256), (256, 512), (512, 768), (768, 1000)]
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 1)  # below one tile: one tile per chunk
    assert sk._edge_chunks(300, per_edge) == [(0, 128), (128, 256), (256, 300)]


@pytest.mark.parametrize("g,m", [(1, 256), (16, 2048), (16, 4096), (256, 4096), (65535, 256), (3, 1 << 20)])
def test_question_chunks_cover_g_within_the_scratch_limit(g, m):
    """Question chunks tile [0, G) in order; each holds whole questions and
    stays within SCRATCH_BYTES unless one question alone needs more.  The
    realistic serve group (G = 16, M = 2048, 128 MiB) is one chunk."""
    per_edge = sk.scratch_bytes_per_edge(1024, 1024, False)
    chunks = sk._question_chunks(g, m, per_edge)
    assert chunks[0][0] == 0 and chunks[-1][1] == g
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(chunks, chunks[1:]))
    for g0, g1 in chunks:
        assert (g1 - g0) * m * per_edge <= sk.SCRATCH_BYTES or g1 - g0 == 1
    if m * per_edge * g <= sk.SCRATCH_BYTES:
        assert chunks == [(0, g)]
    if (g, m) == (256, 4096):
        assert [g1 - g0 for g0, g1 in chunks] == [63, 63, 63, 63, 4]


def test_question_chunks_follow_the_limit(monkeypatch):
    per_edge = sk.scratch_bytes_per_edge(128, 256, False)
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 3 * 300 * per_edge)
    assert sk._question_chunks(8, 300, per_edge) == [(0, 3), (3, 6), (6, 8)]
    monkeypatch.setattr(sk, "SCRATCH_BYTES", 1)  # below one question: one question per chunk
    assert sk._question_chunks(3, 300, per_edge) == [(0, 1), (1, 2), (2, 3)]


def _sc_image_offsets(g, m, d):
    """Flat offset in the sc image of (question q, edge e, direction dr,
    column c): tile q * ceil(m / 128) + e // 128, chunk c // 64, warpgroup
    (e % 128) // 64, direction dr, row r = e % 64, 16-byte unit
    ((c % 64) // 8) ^ (r % 8), element c % 8."""
    q, e, dr, c = np.meshgrid(np.arange(g), np.arange(m), np.arange(2), np.arange(d), indexing="ij")
    t = -(-m // 128)
    r = e % 64
    tile = q * t + e // 128
    chunk = c // 64
    unit = ((c % 64) // 8) ^ (r % 8)
    return ((((tile * (d // 64) + chunk) * 2 + (e % 128) // 64) * 2 + dr) * 64 + r) * 64 + unit * 8 + c % 8


@pytest.mark.parametrize("g,m,d", [(1, 128, 64), (2, 300, 128), (3, 37, 256), (2, 256, 1024)])
def test_sc_image_follows_its_formula(g, m, d):
    rng = np.random.default_rng(g + m + d)
    sc = [torch.as_tensor(rng.normal(size=(g, m, d)).astype(np.float32)).to(torch.bfloat16) for _ in range(2)]
    img = sk.sc_image(*sc)
    t = -(-m // 128)
    assert img.shape == (g * t, d // 64, 2, 2, 64, 64) and img.dtype == torch.bfloat16 and img.is_contiguous()
    assert img[0, 0].numel() * 2 == 32 * 1024  # one slot of the A ring
    flat = img.reshape(-1).float().numpy()
    want = np.zeros(flat.size, np.float32)
    want[_sc_image_offsets(g, m, d)] = torch.stack(sc, dim=2).float().numpy()
    np.testing.assert_array_equal(flat, want)  # rows past M are zero

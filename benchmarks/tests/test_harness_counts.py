"""The frozen counts against the arithmetic they were copied from
(``chip_smoke.py``), and what they count."""

import math

import pytest

import chip_smoke
from benchmarks import counts

D = H = 1024
S, K = 20, 100


def test_kernel2_bound_is_the_headline_bound():
    ms, _ = chip_smoke.pooled_bounds(128, 131072, D, H, S, K)["query_topk_fused"]
    assert counts.kernel2_bound_s(128, 131072, D, H, S, K) * 1e3 == pytest.approx(ms, rel=1e-12)
    assert counts.kernel2_bound_s(128, 131072, D, H, S, K) * 1e3 == pytest.approx(71.985, abs=5e-4)


@pytest.mark.parametrize("lengths,m", [([1200, 800, 3000, 24], 4096), ([100] * 16, 128), ([5000, 7000], 8192)])
def test_kernel3_bound_matches_chip_smoke(lengths, m):
    ms, _ = chip_smoke.kernel_bound(lengths, m, D, H, S, K)
    assert counts.kernel3_bound_s(lengths, m, D, H, S, K) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_kernel3_bound_counts_real_edges_not_the_padded_width():
    one = counts.kernel3_bound_s([1000] * 16, 1024, D, H, S, K)
    assert counts.kernel3_bound_s([1000] * 16, 8192, D, H, S, K) == one
    assert counts.kernel3_bound_s([2000] * 16, 8192, D, H, S, K) == pytest.approx(2 * one, rel=1e-3)


@pytest.mark.parametrize("edges,nodes,graphs", [(30000, 9000, 16), (131071, 16383, 16), (1, 1, 1)])
def test_train_flops_matches_chip_smoke(edges, nodes, graphs):
    assert counts.train_flops(edges, nodes, graphs, D, H) == chip_smoke.train_flops(edges, nodes, graphs, D, H)


def test_pooled_flops_is_the_model_count_of_the_bound():
    b, m = 128, 131072
    assert counts.pooled_flops(b, m, D, H) == 2 * D * H * (2 * b + 3) * m
    tc = chip_smoke.pooled_flops(b, m, D, H)["query_topk_fused"][1]  # as the bound counts it
    assert counts.pooled_flops(b, m, D, H) == tc


def test_serve_flops_is_per_real_edge():
    per_edge = counts.serve_flops(2, 0, D, H, S) - counts.serve_flops(1, 0, D, H, S)
    assert per_edge == 12 * D * H + 4 * S * D + 4 * D + 4 * H
    assert math.isclose(counts.serve_flops(0, 1, D, H, S), 6 * D * D)

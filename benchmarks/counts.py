"""Operations and bytes of the benchmark's work, and the card's published
peaks: the arithmetic of the per-layer shares.  Counts follow the work the
inputs need (real edges, not padded slots), whatever a kernel's tiling."""

from __future__ import annotations

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at 700 W.
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3


def roofline_s(bytes_: float, tc_flops: float, f32_flops: float) -> float:
    """Least seconds: bytes at the memory rate against operations at the
    peak rate of their type, whichever is longer."""
    return max(bytes_ / PEAK_BYTES, tc_flops / PEAK_BF16_FLOPS, f32_flops / PEAK_F32_FLOPS)


def weight_bytes(d: int, h: int, s: int) -> int:
    """Weights a scoring kernel reads: W1's three D x H blocks in bf16, six
    H vectors, the struct projection and five D vectors in f32."""
    return 3 * d * h * 2 + 6 * h * 4 + s * d * 4 + 5 * d * 4


def kernel3_bound_s(lengths, m: int, d: int, h: int, s: int, k: int) -> float:
    """Least time of one per-question launch over questions of ``lengths``
    real edges (at most ``m`` each): their rows (h, r, t, struct in bf16)
    read once, the weights, questions and lengths read once, the top-k
    values and ids written once; [inter | sc | err] @ W1 in two directions
    on the tensor cores; struct projection, LayerNorms, GELUs and products
    at ~12 f32 operations a D or H element."""
    edges = int(sum(min(int(n), m) for n in lengths))
    g = len(lengths)
    bytes_ = edges * (3 * d * 2 + s * 2) + weight_bytes(d, h, s) + g * (d * 4 + 4) + g * k * 8
    tc = edges * 2 * 3 * 2 * d * h
    f32 = edges * 2 * (2 * s * d + 12 * d + 12 * h)
    return roofline_s(bytes_, tc, f32)


def kernel2_bound_s(b: int, m: int, d: int, h: int, s: int, k: int) -> float:
    """Least time of one factorised pooled launch (kernel 2 with its
    select) over ``b`` queries and ``m`` shared candidates: the bf16 rows
    once, the weights and queries once, [b, k] values and ids written once;
    per (candidate, query) u @ W1i and r_ctx @ W1e, per candidate
    hmt @ W1e and [sc_f; sc_b] @ W1s; elementwise work at ~12 operations a
    D or H element."""
    rows = m * (3 * d * 2 + s * 2) + weight_bytes(d, h, s) + b * d * 4
    pairs = b * m
    tc = pairs * 2 * 2 * d * h + m * 3 * 2 * d * h
    f32 = m * 2 * (2 * s * d + 12 * d) + pairs * (12 * d + 2 * 12 * h)
    return roofline_s(rows + b * k * 8, tc, f32)


def pooled_flops(b: int, m: int, d: int, h: int) -> float:
    """Matrix FLOP of one pooled call, by the model's work and not a
    kernel's tiling: 2 D H (2 b + 3) per candidate (the query-dependent
    products per pair, the query-independent ones once a call)."""
    return 2.0 * d * h * (2 * b + 3) * m


def serve_flops(edges: int, questions: int, d: int, h: int, s: int) -> float:
    """Matrix FLOP of serving: per real edge [inter | sc | err] @ W1, the
    struct projection and the folded head in two directions; per question
    the query projection, gate and bias."""
    return float(edges) * (12 * d * h + 4 * s * d + 4 * d + 4 * h) + float(questions) * 6 * d * d


def train_flops(edges: int, nodes: int, graphs: int, d: int, h: int) -> float:
    """FLOP of training steps over real edges, nodes and graphs: 3 x the
    forward's matrix products, forward = 2 [3 E D^2 (relation projection,
    q_gate, q_bias) + 2 E ((3D + 1) H + H^2 + 21 D + H) (two directions:
    state_net_0, state_net_1, struct projection and gate, head) + N D^2
    (entity projection) + G D^2 (query projection)]."""
    fwd = 2 * (3 * edges * d * d + 2 * edges * ((3 * d + 1) * h + h * h + 21 * d + h)
               + nodes * d * d + graphs * d * d)
    return 3.0 * fwd

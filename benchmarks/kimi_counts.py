"""Operations and bytes of the ``kimi_linear`` cell's work
(``drivers/reason_kimi.py``), by the published form of the model and the
share of its experts held here, whatever form the program computes: the
arithmetic of ``kimi.mfu``, ``kimi.decode_roofline`` and ``kda_roofline``,
from the program's ``reason.*``, ``moe.*`` and ``kda.*`` counters."""

from __future__ import annotations

from benchmarks import counts, llm_counts

BYTES = 2   # bf16 weights, activations and cache rows
F32 = 4     # the KDA recurrent state, A_log and dt_bias


def _kda(c: dict) -> tuple[int, int, int, int]:
    """(heads, head width, P = heads x width, conv taps) of the KDA layers."""
    lin = c["linear_attn_config"]
    h, d = int(lin["num_heads"]), int(lin["head_dim"])
    return h, d, h * d, int(lin["short_conv_kernel_size"])


def layer_counts(c: dict) -> dict[str, int]:
    """KDA, MLA, dense and MoE layers."""
    kda = len(c["linear_attn_config"]["kda_layers"])
    dense = c["first_k_dense_replace"]
    return dict(kda=kda, mla=c["num_hidden_layers"] - kda, dense=dense, moe=c["num_hidden_layers"] - dense)


def kda_params(c: dict) -> int:
    """One KDA layer's matrices: q, k, v and their conv taps, beta, the
    decay's and the output gate's low-rank pairs, the out projection."""
    h, d, P, taps = _kda(c)
    D = c["hidden_size"]
    return 3 * P * D + 3 * P * taps + h * D + 2 * (d * D + P * d) + D * P


def mla_params(c: dict) -> int:
    return llm_counts.attention_params(c)


def expert_params(c: dict) -> int:
    return llm_counts.expert_params(c)


def router_experts(c: dict) -> int:
    return c.get("router_experts") or c["num_experts"]


def fixed_params(c: dict) -> int:
    """Matrix parameters every token passes through below the LM head, the
    routed experts left out: attention, the dense MLP, each MoE layer's
    router and shared expert."""
    n = layer_counts(c)
    D = c["hidden_size"]
    return (n["kda"] * kda_params(c) + n["mla"] * mla_params(c) + n["dense"] * 3 * D * c["intermediate_size"]
            + n["moe"] * (router_experts(c) * D + c["num_shared_experts"] * expert_params(c)))


def kda_flops_per_token(c: dict) -> int:
    """The recurrence of one token in one layer: decay, k.S, the update and
    q.S, 4 d^2 a head."""
    h, d, _, _ = _kda(c)
    return 4 * h * d * d


def flops(c: dict, counters: dict) -> float:
    """2 x the fixed parameters a prompt or decode token, 2 x one expert's
    for each (token, expert) pair routed to an expert held here, the LM head
    for each logit row used (a sequence's last prompt token, every decode
    token), the MLA layers' q.k and p.v for every pair of causal context
    (prompts) and cache row read (decode), and the recurrence for every
    KDA token and layer."""
    g = counters.get
    tokens = g("reason.tokens.prefill", 0) + g("reason.tokens.decode", 0)
    routed = g("moe.tokens.routed", 0) + g("moe.tokens.routed.decode", 0)
    heads = g("reason.sequences", 0) + g("reason.tokens.decode", 0)
    pairs = g("reason.ctx.prefill", 0) + g("reason.ctx.decode", 0)
    h, dq, dv = c["num_attention_heads"], c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"]
    return (2.0 * fixed_params(c) * tokens + 2.0 * expert_params(c) * routed
            + 2.0 * c["vocab_size"] * c["hidden_size"] * heads
            + float(layer_counts(c)["mla"] * h * 2 * (dq + dv)) * pairs
            + float(kda_flops_per_token(c)) * (g("kda.tokens.prefill", 0) + g("kda.tokens.decode", 0)))


def state_bytes(c: dict) -> int:
    """One sequence's state in one KDA layer: the f32 recurrent state and
    the conv state (the last taps - 1 projections of q, k and v)."""
    h, d, P, taps = _kda(c)
    return h * d * d * F32 + (taps - 1) * 3 * P * BYTES


def decode_bytes(c: dict, counters: dict, steps: int) -> float:
    """Bytes the decode steps must move: the weights of every held expert a
    step touched; each step's other weights, norms, gates and LM head; the
    MLA layers' latent rows read; every KDA state read and written; each
    token's new latent rows, embedding row and logits."""
    n = layer_counts(c)
    h, d, P, _ = _kda(c)
    D, V = c["hidden_size"], c["vocab_size"]
    row = c["kv_lora_rank"] + c["qk_rope_head_dim"]
    fixed = (BYTES * (fixed_params(c) + V * D + (2 * c["num_hidden_layers"] + 1) * D + n["mla"] * c["kv_lora_rank"]
                      + n["kda"] * d)
             + F32 * n["kda"] * (h + P))
    g = counters.get
    return float(BYTES * g("moe.experts.touched", 0) * expert_params(c) + steps * fixed
                 + BYTES * g("reason.ctx.decode", 0) * n["mla"] * row
                 + 2 * g("kda.states.decode", 0) * state_bytes(c)
                 + BYTES * g("reason.tokens.decode", 0) * (n["mla"] * row + D + V))


def kda_bound_s(c: dict, counters: dict) -> float:
    """The least time of the recurrence's work in the window, by the bytes
    a fused kernel must move: for prefill and for decode apart, the larger
    of its bytes over the memory rate (a token and layer q, k, v and the
    decay's projection read and o written in bf16, beta's projection read
    in bf16; a sequence and layer the f32 state and the conv state read and
    written; the taps, A_log and dt_bias of a launch left out) and its
    operations over the bf16 peak, summed."""
    h, d, P, _ = _kda(c)
    token = 5 * P * BYTES + h * BYTES
    state = 2 * state_bytes(c)
    total = 0.0
    for phase in ("prefill", "decode"):
        tokens, states = counters.get(f"kda.tokens.{phase}", 0), counters.get(f"kda.states.{phase}", 0)
        total += max((tokens * token + states * state) / counts.PEAK_BYTES,
                     tokens * kda_flops_per_token(c) / counts.PEAK_BF16_FLOPS)
    return total

"""Operations and bytes of the reasoner LLM's work (``drivers/reason.py``),
by the published form of a ``deepseek_v3`` model, whatever form the
program computes: the arithmetic of ``reason.mfu`` and
``reason.decode_roofline``, from the program's counters."""

from __future__ import annotations

BYTES = 2  # bf16 weights and cache


def _dims(c: dict):
    d, h = c["hidden_size"], c["num_attention_heads"]
    dq = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    r, dr, dv = c["kv_lora_rank"], c["qk_rope_head_dim"], c["v_head_dim"]
    return d, h, dq, r, dr, dv


def attention_params(c: dict) -> int:
    """One layer's MLA matrices: q, kv_a, kv_b, o."""
    d, h, dq, r, dr, dv = _dims(c)
    return h * dq * d + (r + dr) * d + h * (c["qk_nope_head_dim"] + dv) * r + d * h * dv


def expert_params(c: dict) -> int:
    """One routed expert: gate, up and down."""
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def layer_counts(c: dict) -> tuple[int, int]:
    """(dense layers, MoE layers)."""
    dense = c["first_k_dense_replace"]
    return dense, c["num_hidden_layers"] - dense


def active_params(c: dict) -> int:
    """Matrix parameters one token passes through below the LM head:
    attention, the dense MLPs, and in each MoE layer the router, the shared
    experts and ``num_experts_per_tok`` routed experts."""
    dense, moe = layer_counts(c)
    d = c["hidden_size"]
    per_moe = c["n_routed_experts"] * d + (c["n_shared_experts"] + c["num_experts_per_tok"]) * expert_params(c)
    return c["num_hidden_layers"] * attention_params(c) + dense * 3 * d * c["intermediate_size"] + moe * per_moe


def attention_flops_per_pair(c: dict) -> int:
    """q.k over qk_nope + qk_rope dims and p.v over v dims, every head and
    layer, for one (query, key) pair of causal context."""
    _, h, dq, _, _, dv = _dims(c)
    return c["num_hidden_layers"] * h * 2 * (dq + dv)


def flops(c: dict, counters: dict) -> float:
    """2 x active parameters a token for prompt and decode tokens, the LM
    head for each token whose logits are used (a sequence's last prompt
    token, every decode token), and the attention products of every pair of
    causal context (prompts) and cache row read (decode)."""
    tokens = counters.get("reason.tokens.prefill", 0) + counters.get("reason.tokens.decode", 0)
    heads = counters.get("reason.sequences", 0) + counters.get("reason.tokens.decode", 0)
    pairs = counters.get("reason.ctx.prefill", 0) + counters.get("reason.ctx.decode", 0)
    return (2.0 * active_params(c) * tokens + 2.0 * c["vocab_size"] * c["hidden_size"] * heads
            + float(attention_flops_per_pair(c)) * pairs)


def decode_bytes(c: dict, counters: dict, steps: int) -> float:
    """Bytes the decode steps must move: the bf16 weights of every expert a
    step touched; each step's attention, dense, router and shared weights,
    norms and LM head; the latent cache rows read; each step's new cache
    rows, embedding rows and logits."""
    dense, moe = layer_counts(c)
    d, v, L = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    row = c["kv_lora_rank"] + c["qk_rope_head_dim"]
    fixed = (L * attention_params(c) + dense * 3 * d * c["intermediate_size"]
             + moe * (c["n_routed_experts"] * d + c["n_shared_experts"] * expert_params(c))
             + v * d + (2 * L + 1) * d + L * c["kv_lora_rank"])
    tokens = counters.get("reason.tokens.decode", 0)
    return float(BYTES * (counters.get("moe.experts.touched", 0) * expert_params(c) + steps * fixed
                          + counters.get("reason.ctx.decode", 0) * L * row
                          + tokens * (L * row + d + v)))

"""Kimi-Linear-48B-A3B in the reasoner's engine (``models/llm/kimi_linear.py``,
``ops/kda.py``, ``eval/local_llm.py``) held to the plain reference
(``benchmarks/reference/kimi_linear.py``) at a tiny size on the CPU, with
seeded random weights: hidden 64, 4 heads of 16 (KDA and MLA), 6 layers
K K K M K M with layer 0 dense, 16 experts scored with 8 held, top-2.

* prefill then decode through both caches (latent rows, KDA and conv
  states) give the reference's full-forward logits and KDA states;
* a chunk of mixed lengths leaves every sequence's KDA and conv state as
  running it alone does;
* the plain route's recurrence equals the reference's with A_log at the top
  of its range (the fastest decay);
* the routed parts of two shares of the experts plus the shared expert
  counted once add up to the uncut layer, with or without the static form
  a captured decode step takes;
* the model file refuses unknown keys and values;
* the spans and counters under a profiler, none while off;
* on a card (``cuda``-marked, skipped here): the KDA kernel against the
  plain route, prefill and decode.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.reference import kimi_linear as ref
from evi_rag_tpu_torch.eval import llm_client, local_llm
from evi_rag_tpu_torch.models.llm import kimi_linear, moonlight, read_model_file
from evi_rag_tpu_torch.models.llm.config import KimiLinearConfig
from evi_rag_tpu_torch.ops import kda
from evi_rag_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "configs" / "reasoner" / "models" / "kimi_linear_48b_a3b.json").read_text())
TINY = dict(PUBLISHED, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=6,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16, num_experts=8, router_experts=16, num_experts_per_token=2,
            vocab_size=512, model_max_length=256,
            linear_attn_config=dict(PUBLISHED["linear_attn_config"], kda_layers=[1, 2, 3, 5],
                                    full_attn_layers=[4, 6], num_heads=4, head_dim=16))
SEED = 11
N_KDA, N_MOE = 4, 5


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _llm(dtype="float32", **kw):
    kw.setdefault("max_tokens", 6)
    return local_llm.LocalLLM.from_config(TINY, seed=SEED, device="cpu", dtype=dtype, **kw)


def _prompts(lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, TINY["vocab_size"], n) for n in lengths]


def _rel(a, b):
    return float((a.float() - b).norm() / b.norm())


@pytest.mark.parametrize("dtype,tol,state_tol", [("float32", 1e-4, 1e-4), ("bfloat16", 0.03, 0.03)])
def test_prefill_then_decode_gives_the_references_logits_and_states(dtype, tol, state_tol):
    """Every logit the engine produced (the last prompt position's and each
    decode step's) and every KDA state after each prompt, against the
    reference's full forward over prompt + generated ids, in the relative
    norm, the reference taking the engine's experts; in f32 they are the
    reference's own choices, in bf16 within a rounding of them."""
    llm = _llm(dtype)
    prompts = _prompts([9, 23, 5, 40])
    tokens, kept = llm.generate(prompts, keep=range(len(prompts)))
    assert tokens.shape == (4, 6) and [s.shape for s in kept.states] == [(N_KDA, 4, 16, 16)] * 4
    assert [r.shape for r in kept.routes] == [(N_MOE, len(p) + 5, 2) for p in prompts]
    seqs = [torch.as_tensor(np.concatenate([p, t[:-1]])) for p, t in zip(prompts, tokens)]
    starts = [len(p) - 1 for p in prompts]
    _, own, _, _ = ref.forward(llm.weights, TINY, seqs, starts)
    want, _, route_gap, states = ref.forward(llm.weights, TINY, seqs, starts, routes=kept.routes)
    assert route_gap <= (0.0 if dtype == "float32" else 0.02)
    for j in range(4):
        assert _rel(kept.logits[j], want[j]) < tol, j
        assert max(_rel(a, b) for a, b in zip(kept.states[j], states[j])) < state_tol, j
        if dtype == "float32":
            assert torch.equal(torch.as_tensor(tokens[j]), kept.logits[j].argmax(-1))
            assert torch.equal(own[j].sort(-1).values, kept.routes[j].sort(-1).values)


def _prefill_alone_and_together(lengths):
    cfg = KimiLinearConfig.from_dict(TINY)
    w = kimi_linear.init_weights(cfg, SEED, "cpu", torch.float32)
    prompts = _prompts(lengths, seed=3)
    caches = []
    for chunks in ([list(range(len(prompts)))], [[i] for i in range(len(prompts))]):
        cache = kimi_linear.new_cache(cfg, len(prompts), 64, torch.float32, "cpu")
        for chunk in chunks:
            ids, seq, pos, pad, b, lc, last = local_llm.chunk_inputs(prompts, chunk, "cpu")
            kimi_linear.prefill(w, cfg, ids, seq, pos, pad, b, lc, cache, last)
        caches.append(cache)
    return caches


def test_a_chunk_of_mixed_lengths_leaves_each_state_as_alone():
    together, alone = _prefill_alone_and_together([30, 1, 2, 17, 3])
    for kind in ("state", "conv", "latent"):
        torch.testing.assert_close(getattr(together, kind), getattr(alone, kind), rtol=1e-5, atol=1e-6)
    # The conv state holds each sequence's last 3 projections, zeros before its start.
    assert together.conv[:, 1, :2].abs().sum() == 0 and together.conv[:, 1, 2].abs().sum() > 0
    assert together.conv[:, 2, :1].abs().sum() == 0 and together.conv[:, 2, 1:].abs().sum() > 0


def test_the_plain_recurrence_equals_the_references_at_the_fastest_decay():
    cfg = KimiLinearConfig.from_dict(TINY)
    w = kimi_linear.init_weights(cfg, SEED, "cpu", torch.float32)
    p, L = "layers.1.", 33
    w[p + "A_log"] = torch.full((4,), float(np.log(16.0)))
    x = torch.randn(L, cfg.hidden_size, generator=torch.Generator().manual_seed(5))
    state = torch.zeros(1, 4, 16, 16)
    conv = torch.zeros(1, 3, 3 * cfg.kda_width)
    one = torch.zeros(1, dtype=torch.int32)
    got = kimi_linear.kda(x, w, p, cfg, state, conv, one, one, torch.tensor([L], dtype=torch.int32))
    lw = {k[len(p):]: v for k, v in w.items() if k.startswith(p)}
    want, s = ref._kda(x, lw, TINY, L - 1, None)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(state[0], s, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("static", [False, True])
def test_two_shares_of_the_experts_add_up_to_the_uncut_layer(static):
    """Share A holds experts 0-7, share B 8-15 (its router's rows put them
    first); each computes its routed part, the shared expert counted once."""
    cut = KimiLinearConfig.from_dict(TINY)
    whole = KimiLinearConfig.from_dict(dict(TINY, num_experts=16))
    w = kimi_linear.init_weights(whole, SEED, "cpu", torch.float32)
    p = "layers.2."
    x = torch.randn(37, cut.hidden_size, generator=torch.Generator().manual_seed(8))
    perm = torch.cat((torch.arange(8, 16), torch.arange(8)))
    share_a = dict(w, **{p + "experts.gate_up": w[p + "experts.gate_up"][:8],
                         p + "experts.down": w[p + "experts.down"][:8]})
    share_b = dict(w, **{p + "router": w[p + "router"][perm], p + "router_bias": w[p + "router_bias"][perm],
                         p + "experts.gate_up": w[p + "experts.gate_up"][8:],
                         p + "experts.down": w[p + "experts.down"][8:]})
    shared = moonlight.mlp(x, w[p + "shared.gate_up"], w[p + "shared.down"])
    a = moonlight.moe(x, share_a, p, cut, static=static)
    b = moonlight.moe(x, share_b, p, cut, static=static)
    torch.testing.assert_close(a + b - shared, moonlight.moe(x, w, p, whole), rtol=1e-5, atol=1e-6)
    lw = {k[len(p):]: v for k, v in share_a.items() if k.startswith(p)}
    want, _, _ = ref._moe(x, lw, TINY)
    torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("change,match", [
    ({"mla_use_nope": False}, "mla_use_nope"), ({"q_lora_rank": 1536}, "q_lora_rank"),
    ({"moe_router_activation_func": "softmax"}, "moe_router_activation_func"), ({"fused_kda": True}, "fused_kda"),
    ({"linear_attn_config": dict(PUBLISHED["linear_attn_config"], kda_layers=[1, 2])}, "split layers"),
    ({"linear_attn_config": dict(PUBLISHED["linear_attn_config"], gate_low_rank=64)}, "linear_attn_config"),
    ({"num_experts": 300}, "num_experts"), ({"model_type": "kimi_k2"}, "model_type")])
def test_model_file_refuses_what_it_does_not_implement(change, match):
    cfg = read_model_file(PUBLISHED)
    assert isinstance(cfg, KimiLinearConfig) and cfg.router_experts == 256 and cfg.n_routed_experts == 32
    assert cfg.kda_layers == [0, 1, 2, 4, 5, 6, 8, 9, 10, 12, 13, 14, 16, 17, 18, 20, 21, 22, 24, 25]
    assert cfg.mla_layers == [3, 7, 11, 15, 19, 23, 26] and cfg.max_positions == 1_048_576
    with pytest.raises(ValueError, match=match):
        read_model_file(dict(PUBLISHED, **change))


def test_the_local_backend_picks_the_model_by_its_type(tmp_path):
    model_file = tmp_path / "tiny.json"
    model_file.write_text(json.dumps(TINY))
    llm = llm_client.init_llm(llm_client.LLMConfig(model_name="m", backend="local", model_file=str(model_file),
                                                   max_tokens=3, device="cpu"))
    assert llm.model is kimi_linear and isinstance(llm.cfg, KimiLinearConfig)
    reply = json.loads(llm([{"role": "user", "content": "what is the capital of x?"}]))
    assert len(reply["answers"][0].split("><")) == 3


SPANS = {"reason.tokenize", "reason.prefill", "reason.decode", "kda.scan"}
COUNTERS = {"reason.sequences", "reason.tokens.prefill", "reason.tokens.decode", "reason.ctx.prefill",
            "reason.ctx.decode", "moe.experts.touched", "moe.tokens.max", "moe.tokens.routed",
            "moe.tokens.routed.decode", "kda.tokens.prefill", "kda.tokens.decode", "kda.states.prefill",
            "kda.states.decode"}


def test_spans_and_counters_under_a_profiler_and_none_off():
    llm = _llm(max_tokens=4, prefill_tokens=40)
    convs = [[{"role": "user", "content": "x" * n}] for n in (40, 90, 13)]
    off = llm.batch(convs)
    assert profiling.totals() == dict(spans={}, counters={})
    with profile(activities=[ProfilerActivity.CPU]):
        replies, prompts, tokens, kept = llm.run(convs, keep=range(3))
    assert replies == off
    tot = profiling.totals()
    assert set(tot["spans"]) == SPANS and set(tot["counters"]) == COUNTERS
    lens = [len(p) for p in prompts]
    c, chunks = tot["counters"], len(local_llm.plan_chunks(lens, 40))
    assert tot["spans"]["kda.scan"]["count"] == chunks * N_KDA
    assert c["kda.tokens.prefill"] == sum(lens) * N_KDA and c["kda.states.prefill"] == 3 * N_KDA
    assert c["kda.tokens.decode"] == c["kda.states.decode"] == 3 * 3 * N_KDA
    held = [int((r[:, :len(p)] < 8).sum()) for r, p in zip(kept.routes, prompts)]
    assert c["moe.tokens.routed"] == sum(held) and 0 < sum(held) < sum(lens) * 2 * N_MOE
    held_decode = [int((r[:, len(p):] < 8).sum()) for r, p in zip(kept.routes, prompts)]
    assert c["moe.tokens.routed.decode"] == sum(held_decode)
    assert c["moe.experts.touched"] <= 3 * N_MOE * 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the KDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [[300, 0, 1, 77, 129], [1] * 9])
def test_kda_kernel_matches_the_plain_route(cuda, lengths):
    """Prefill runs of mixed lengths (one a pad of 0) and decode runs of 1,
    from nonzero recurrent and conv states in shuffled cache rows, at the
    kernel's head width: outputs to a bf16 rounding, states to f32 sums in
    another order, conv states exactly."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    h, d, n = 4, kda.DIM, sum(lengths)
    P, rows = h * d, len(lengths) + 2
    rnd = lambda *s: torch.randn(*s, device=cuda, generator=gen)  # noqa: E731
    q, k, v, f = (rnd(n, P).to(torch.bfloat16) for _ in range(4))
    taps = tuple((rnd(P, 4) * 0.3).to(torch.bfloat16) for _ in range(3))
    b = rnd(n, h).to(torch.bfloat16)
    a_log = torch.tensor([0.0, 1.0, 2.0, float(np.log(16.0))], device=cuda)
    dt_bias = rnd(P) - 4
    state, conv = rnd(rows, h, d, d) * 0.1, rnd(rows, 3, 3 * P).to(torch.bfloat16)
    slots = torch.randperm(rows, device=cuda, generator=gen)[:len(lengths)].int()
    starts = torch.tensor(np.cumsum([0] + lengths[:-1]), dtype=torch.int32, device=cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    plain_state, plain_conv = state.clone(), conv.clone()
    got = kda.scan(q, k, v, taps, f, b, a_log, dt_bias, state, conv, slots, starts, lens, d ** -0.5)
    want = kda.scan_plain(q, k, v, taps, f, b, a_log, dt_bias, plain_state, plain_conv, slots.cpu(), starts.cpu(),
                          lens.cpu(), d ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(state, plain_state, rtol=1e-4, atol=1e-5)
    assert torch.equal(conv, plain_conv)
    real = torch.cat([torch.arange(s, s + m) for s, m in zip(starts.tolist(), lengths)]).to(cuda)
    torch.testing.assert_close(got[real].float(), want[real].float(), rtol=0.02, atol=0.02)

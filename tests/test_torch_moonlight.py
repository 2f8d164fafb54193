"""The in-process reasoner LLM (``models/llm/``, ``eval/local_llm.py``) held
to the plain reference (``benchmarks/reference/moonlight.py``) at a tiny
size on the CPU, with seeded random weights: hidden 64, 4 heads, kv rank
32, rope 16, 8 experts with top-2, 2 shared, 3 layers with layer 0 dense.

* prefill and then decode through the latent cache give the reference's
  logits of a full forward over prompt + generated ids;
* the absorbed decode attention equals the expanded form;
* chunked prefill equals one chunk;
* the router chooses by score + bias and weights by the score alone;
* the model file is refused for an unknown key or an unimplemented value;
* ``run_reasoner`` over the ``local`` backend writes what one record a
  call writes, ``cli reasoner reasoner=local_moonlight`` runs end to end,
  and the mock backend keeps its one-record calls;
* the engine's spans and counters under a profiler, nothing while off.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmarks.reference import moonlight as moonlight_ref
from evi_rag_tpu_torch.eval import llm_client, local_llm, reasoner
from evi_rag_tpu_torch.models.llm import moonlight
from evi_rag_tpu_torch.models.llm.config import MoonlightConfig
from evi_rag_tpu_torch.utils import profiling

ROOT = pathlib.Path(__file__).resolve().parents[1]
PUBLISHED = json.loads((ROOT / "configs" / "reasoner" / "models" / "moonlight_16b_a3b.json").read_text())
TINY = dict(PUBLISHED, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
            vocab_size=512, max_position_embeddings=256)
SEED = 7


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


def _reference(llm, prompts, tokens, routes=None):
    seqs = [torch.as_tensor(np.concatenate([p, t[:-1]])) for p, t in zip(prompts, tokens)]
    return moonlight_ref.forward(llm.weights, TINY, seqs, [len(p) - 1 for p in prompts], routes=routes)


@pytest.mark.parametrize("dtype,tol,route_tol", [("float32", 1e-4, 0.0), ("bfloat16", 0.03, 0.02)])
def test_prefill_then_decode_gives_the_references_logits(dtype, tol, route_tol):
    """Every logit the engine produced (the last prompt position's and each
    decode step's) against the reference's full forward over prompt +
    generated ids, in the relative norm, the reference taking the experts
    the engine chose; those choices are the reference's own top k (f32) or
    within a rounding of them (bf16: one rounding of every product against
    the reference's f32)."""
    llm = _llm(dtype, max_tokens=6)
    prompts = _prompts([9, 23, 5, 40])
    tokens, kept = llm.generate(prompts, keep=range(len(prompts)))
    assert tokens.shape == (4, 6)
    assert [r.shape for r in kept.routes] == [(2, len(p) + 5, 2) for p in prompts]
    free, own, _ = _reference(llm, prompts, tokens)
    wants, _, route_gap = _reference(llm, prompts, tokens, kept.routes)
    assert route_gap <= route_tol
    for j, want in enumerate(wants):
        err = float((kept.logits[j] - want).norm() / want.norm())
        assert err < tol, (j, err)
        if dtype == "float32":
            assert torch.equal(torch.as_tensor(tokens[j]), kept.logits[j].argmax(-1))
            assert torch.equal(own[j].sort(-1).values, kept.routes[j].sort(-1).values)
            torch.testing.assert_close(free[j], want)


def test_absorbed_decode_equals_expanded_attention():
    cfg = MoonlightConfig.from_dict(TINY)
    w = moonlight.init_weights(cfg, SEED, "cpu", torch.float32)
    p, L = "layers.1.", 12
    x = torch.randn(L, cfg.hidden_size, generator=torch.Generator().manual_seed(3))
    pos = torch.arange(L)
    cos, sin = moonlight.rope_tables(cfg, pos)
    cache = torch.zeros(1, L, cfg.latent_dim)
    full = moonlight.attend_expanded(x, w, p, cfg, cos, sin, cache, (torch.zeros(L, dtype=torch.long), pos),
                                     pos, 1, L)
    last = torch.tensor([L - 1])
    cos1, sin1 = moonlight.rope_tables(cfg, last)
    rows = cache.clone()
    rows[0, L - 1] = 0  # the decode step writes its own row
    one = moonlight.attend_absorbed(x[L - 1:], w, p, cfg, cos1, sin1, rows, (torch.zeros(1, dtype=torch.long), last),
                                    torch.zeros(1, 1, L, dtype=torch.bool))
    torch.testing.assert_close(one[0], full[L - 1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rows, cache)


@pytest.mark.parametrize("budget", [1, 40, 64])
def test_chunked_prefill_equals_one_chunk(budget):
    prompts = _prompts([30, 7, 18, 18, 2], seed=1)
    one_tokens, one = _llm(prefill_tokens=4096).generate(prompts, keep=range(5))
    assert len(local_llm.plan_chunks([len(p) for p in prompts], budget)) > 1
    tokens, chunked = _llm(prefill_tokens=budget).generate(prompts, keep=range(5))
    np.testing.assert_array_equal(tokens, one_tokens)
    torch.testing.assert_close(chunked.logits, one.logits, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(chunked.routes, one.routes))


def test_router_chooses_with_the_bias_and_weights_without_it():
    cfg = MoonlightConfig.from_dict(TINY)
    w = moonlight.init_weights(cfg, SEED, "cpu", torch.float32)
    p = "layers.1."
    x = torch.randn(5, cfg.hidden_size, generator=torch.Generator().manual_seed(4))
    scores = torch.sigmoid(x @ w[p + "router"].t())
    w[p + "router_bias"] = torch.zeros(cfg.n_routed_experts)
    w[p + "router_bias"][[3, 6]] = 10.0  # every token must now choose experts 3 and 6
    ids, wts = moonlight.route(x, w, p, cfg)
    assert sorted(ids[0].tolist()) == [3, 6] and all(sorted(r.tolist()) == [3, 6] for r in ids)
    want = scores.gather(1, ids)
    want = want / want.sum(-1, keepdim=True) * cfg.routed_scaling_factor
    torch.testing.assert_close(wts, want)


@pytest.mark.parametrize("change,match", [({"rope_scaling": None}, "rope_scaling"),
                                          ({"q_lora_rank": 1536}, "q_lora_rank"),
                                          ({"scoring_func": "softmax"}, "scoring_func")])
def test_model_file_refuses_what_it_does_not_implement(change, match):
    MoonlightConfig.from_dict(PUBLISHED)
    with pytest.raises(ValueError, match=match):
        MoonlightConfig.from_dict(dict(PUBLISHED, **change))


def _records(n=7):
    rng = np.random.default_rng(2)
    out = []
    for i in range(n):
        trip = [(f"ent {rng.integers(100)}", "people.person.place_of_birth", f"ent {rng.integers(100)}")
                for _ in range(int(rng.integers(1, 6)))]
        out.append({"id": f"q{i}", "window_k": 5, "question": f"where is {i}?", "answers": ["ent 1"],
                    "prompt": reasoner.build_triplet_prompt(f"where is {i}?", trip, 5), "hit_set": False,
                    "hit_vis": False, "visible_edge_ids": [], "retrieved_edge_ids": [], "evidence_token_count": 1,
                    "prompt_token_count": 1, "token_budget": 0, "evidence_truncated": False})
    return out


def test_run_reasoner_batched_writes_what_one_record_a_call_writes(tmp_path):
    llm = _llm(max_batch=3)
    recs = _records()
    reasoner.run_reasoner(recs, mode="llm", llm=llm, output_path=tmp_path / "batched.jsonl")

    class One:  # the same engine, one record a call
        def __call__(self, messages):
            return llm(messages)

    reasoner.run_reasoner(recs, mode="llm", llm=One(), output_path=tmp_path / "one.jsonl")
    batched = (tmp_path / "batched.jsonl").read_text()
    assert batched == (tmp_path / "one.jsonl").read_text()
    preds = [json.loads(line)["prediction"] for line in batched.splitlines()]
    assert len(preds) == 7 and all(len(json.loads(p)["answers"][0].split("><")) == 6 for p in preds)


def test_mock_backend_keeps_one_record_a_call(tmp_path):
    mock = llm_client.init_llm(llm_client.LLMConfig(model_name="mock", backend="mock",
                                                    mock_response='{"answers": ["ent 1"]}'))
    assert not hasattr(mock, "batch")
    calls = []

    def counted(messages):
        calls.append(messages)
        return mock(messages)

    reasoner.run_reasoner(_records(), mode="llm", llm=counted, output_path=tmp_path / "m.jsonl")
    assert len(calls) == 7 and calls[0] == reasoner.chat_messages(_records()[0])
    assert all(json.loads(x)["prediction"] == '{"answers": ["ent 1"]}'
               for x in (tmp_path / "m.jsonl").read_text().splitlines())


def test_cli_reasoner_local_moonlight_on_the_cpu(tmp_path):
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.eval.artifacts import save_agent_store
    from tests.test_torch_reasoner import _agent_samples

    _, samples = _agent_samples(n=3, seed=5)
    save_agent_store(samples, tmp_path / "art" / "g_agent" / "validation", split="validation")
    model_file = tmp_path / "tiny.json"
    model_file.write_text(json.dumps(TINY))
    rc = cli.main(["reasoner", "--configs-dir", str(ROOT / "configs"), "reasoner=local_moonlight", "device=cpu",
                   f"reasoner.model_file={model_file}", "reasoner.max_tokens=4",
                   f"gflownet.g_agent_dir={tmp_path / 'art' / 'g_agent'}", f"eval.artifacts_dir={tmp_path / 'art'}",
                   "eval.splits=[validation]", f"paths.log_dir={tmp_path / 'logs'}"])
    assert rc == 0
    preds = [json.loads(x) for x in (tmp_path / "art" / "reasoner" / "validation.jsonl").read_text().splitlines()]
    assert len(preds) == 3 * 3 and {p["window_k"] for p in preds} == {25, 50, 100}
    assert all(len(json.loads(p["prediction"])["answers"][0].split("><")) == 4 for p in preds)


SPANS = {"reason.tokenize", "reason.prefill", "reason.decode"}
COUNTERS = {"reason.sequences", "reason.tokens.prefill", "reason.tokens.decode", "reason.ctx.prefill",
            "reason.ctx.decode", "moe.experts.touched", "moe.tokens.max", "moe.tokens.routed"}


def test_engine_spans_and_counters_under_a_profiler_and_none_off():
    llm = _llm(max_tokens=4, prefill_tokens=40)
    convs = [reasoner.chat_messages(r) for r in _records(3)]
    off = llm.batch(convs)
    assert profiling.totals() == dict(spans={}, counters={})
    with profile(activities=[ProfilerActivity.CPU]):
        on = llm.batch(convs)
    assert on == off
    tot = profiling.totals()
    assert set(tot["spans"]) == SPANS and set(tot["counters"]) == COUNTERS
    lens = [len(llm.tokenizer.encode(local_llm.render_chat(c))) for c in convs]
    c, moe_layers = tot["counters"], TINY["num_hidden_layers"] - TINY["first_k_dense_replace"]
    assert tot["spans"]["reason.decode"]["count"] == 3
    assert tot["spans"]["reason.prefill"]["count"] == len(local_llm.plan_chunks(lens, 40))
    assert c["reason.sequences"] == 3 and c["reason.tokens.prefill"] == sum(lens)
    assert c["reason.tokens.decode"] == 3 * 3
    assert c["reason.ctx.prefill"] == sum(m * (m + 1) // 2 for m in lens)
    assert c["reason.ctx.decode"] == sum(sum(lens) + 3 * t for t in (1, 2, 3))
    assert c["moe.tokens.routed"] == sum(lens) * 2 * moe_layers
    assert sum(lens) * 2 * moe_layers / 8 <= c["moe.tokens.max"] <= sum(lens) * moe_layers
    assert 3 * moe_layers <= c["moe.experts.touched"] <= 3 * moe_layers * 6


def test_local_backend_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    model_file = tmp_path / "tiny.json"
    model_file.write_text(json.dumps(TINY))
    cfg = llm_client.LLMConfig(model_name="m", backend="local", model_file=str(model_file), max_tokens=2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is used")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llm_client.init_llm(cfg)
    llm = llm_client.init_llm(dataclasses.replace(cfg, device="cpu"))
    assert isinstance(llm, local_llm.LocalLLM) and llm.max_batch == 48


def test_the_serve_path_loads_no_llm_code():
    import subprocess
    import sys

    code = ("import sys, evi_rag_tpu_torch.serving, evi_rag_tpu_torch.cli; "
            "print(sorted(m for m in sys.modules if m.startswith(('evi_rag_tpu_torch.models.llm', "
            "'evi_rag_tpu_torch.eval.local_llm'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

"""Port vs JAX: the reasoner's prompts, oracle, metrics, records and chat
backends.

* Prompts, the oracle, ``evaluate_predictions`` (the random records of
  ``tests/test_reference_parity_llm_metrics.py``, seeds 0-3) and the
  triplet and path records: equal to JAX's on the same inputs.
* ``count_tokens``: equal to JAX's on a set of strings with tiktoken
  working, failing its lookup (offline) and absent.  Both packages see a
  stand-in ``tiktoken`` module, so that no test reaches for the encoding
  file over the network; the port looks the encoding up once per model.
* Budget truncation, path hits, the ollama request contract, retry and
  backoff with a patched sleep, the import-gated ``openai`` / ``vllm``
  errors (no backend falls back to another).
"""

import dataclasses
import io
import json
import sys
import types

import numpy as np
import pytest

from evi_rag_tpu.data.chains import ChainSettings, build_bfs_candidate_chains, chains_from_rollouts
from evi_rag_tpu.data.g_agent import AgentSettings, build_agent_sample
from evi_rag_tpu.data.synthetic import make_synthetic_dataset
from evi_rag_tpu.eval import llm_client as jclient
from evi_rag_tpu.eval import llm_metrics as jmetrics
from evi_rag_tpu.eval import oracle as joracle
from evi_rag_tpu.eval import prompting as jprompting
from evi_rag_tpu.eval import reasoner as jreasoner
from evi_rag_tpu_torch.data.g_agent import AgentSample as TAgentSample
from evi_rag_tpu_torch.eval import llm_client as tclient
from evi_rag_tpu_torch.eval import llm_metrics as tmetrics
from evi_rag_tpu_torch.eval import oracle as toracle
from evi_rag_tpu_torch.eval import prompting as tprompting
from evi_rag_tpu_torch.eval import reasoner as treasoner
from tests.test_reference_parity_llm_metrics import _rand_records

STRINGS = ["", "a", "abcd", "hello world", "(Barack Obama, people.person.place_of_birth, Honolulu)",
           "Triplets:\n(a, r, b)\n(c, r2, d)", "x" * 999, "naïve café — ünïcode ✓"]


class _Encoding:
    """A stand-in tiktoken encoding: one token per whitespace-separated word
    and per punctuation mark."""

    def encode(self, text):
        return [w for w in text.replace(",", " , ").replace("(", " ( ").split() if w]


def _fake_tiktoken(mode: str, calls: list):
    mod = types.ModuleType("tiktoken")

    def encoding_for_model(model):
        calls.append(model)
        if mode == "offline":
            raise ConnectionError("no network")  # tiktoken's download of the encoding file fails
        if model == "unknown-model":
            raise KeyError(model)
        return _Encoding()

    def get_encoding(name):
        calls.append(name)
        return _Encoding()

    mod.encoding_for_model, mod.get_encoding = encoding_for_model, get_encoding
    return mod


@pytest.fixture
def tiktoken_mode(monkeypatch, request):
    """(mode, lookups): a stand-in ``tiktoken`` in ``sys.modules`` ("working",
    "offline": its lookup fails, "absent": None), and the list of the
    lookups made through it.  The port's per-process cache is cleared
    before and after."""
    calls: list = []
    mode = getattr(request, "param", "offline")
    monkeypatch.setitem(sys.modules, "tiktoken", None if mode == "absent" else _fake_tiktoken(mode, calls))
    tprompting.token_encoding.cache_clear()
    yield mode, calls
    tprompting.token_encoding.cache_clear()


@pytest.mark.parametrize("tiktoken_mode", ["working", "offline", "absent"], indirect=True)
def test_count_tokens_matches_jax(tiktoken_mode):
    mode, calls = tiktoken_mode
    models = ("gpt-4o-mini", "unknown-model")
    for model in models:
        for text in STRINGS:
            assert tprompting.count_tokens(text, model=model) == jprompting.count_tokens(text, model=model), \
                (model, text)
    if mode == "working":
        assert tprompting.count_tokens("(a, b)") == 4
    # JAX looks the encoding up on every call; the port once per model, a
    # failed lookup included (an unknown model falls back to cl100k_base).
    tprompting.token_encoding.cache_clear()
    calls.clear()
    for model in models:
        for text in STRINGS:
            tprompting.count_tokens(text, model=model)
    assert len(calls) == {"working": 3, "offline": 2, "absent": 0}[mode]


def test_prompts_match_jax():
    rng = np.random.default_rng(0)
    triplets = [(f"e{rng.integers(99)}", f"r{rng.integers(9)}", f"e{rng.integers(99)}") for _ in range(12)]
    for limit in (0, 1, 5, 20):
        assert tprompting.build_triplet_prompt("who?", triplets, limit) == \
            jprompting.build_triplet_prompt("who?", triplets, limit)
    chains = [{"chain_text": f"A --[r{i}]--> B{i}", "frequency": i, "length": 1 + i % 3} for i in range(6)]
    for limit in (0, 3, 10):
        for meta in (False, True):
            kw = dict(question="q?", chains=chains, limit=limit, include_meta=meta)
            assert tprompting.build_path_prompt(**kw) == jprompting.build_path_prompt(**kw)


def test_oracle_matches_jax():
    rng = np.random.default_rng(1)
    per = {"jax": [], "port": []}
    for _ in range(20):
        e = int(rng.integers(0, 30))
        kw = dict(head_entity_ids=rng.integers(0, 40, e), tail_entity_ids=rng.integers(0, 40, e),
                  answer_entity_ids=rng.integers(0, 40, int(rng.integers(0, 4))), k_values=[1, 5, 10, 50])
        per["jax"].append(joracle.oracle_metrics_for_sample(**kw))
        per["port"].append(toracle.oracle_metrics_for_sample(**kw))
        assert per["port"][-1] == per["jax"][-1]
    assert toracle.aggregate_oracle_metrics(per["port"]) == joracle.aggregate_oracle_metrics(per["jax"])
    assert toracle.aggregate_oracle_metrics([]) == {}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluate_predictions_matches_jax(seed):
    records = _rand_records(seed)
    assert tmetrics.evaluate_predictions(records) == jmetrics.evaluate_predictions(records)
    for r in records:
        assert tmetrics.parse_prediction(r["prediction"]) == jmetrics.parse_prediction(r["prediction"])
    bad = dict(records[0])
    del bad["hit_vis"]
    with pytest.raises(ValueError, match="hit_vis"):
        tmetrics.evaluate_predictions([bad])


def _agent_samples(n=4, seed=3):
    """JAX agent samples of the synthetic generator and the port's copies."""
    ds = make_synthetic_dataset(num_samples=8, emb_dim=8, max_nodes=14, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for s in ds.samples:
        a = build_agent_sample(
            sample_id=s.sample_id, question_id=s.question_id, heads=s.edge_index[0], tails=s.edge_index[1],
            relations=s.edge_relations, labels=s.edge_labels.astype(np.float32),
            scores=(rng.normal(size=s.edge_index.shape[1]) + 2.0 * s.edge_labels).astype(np.float32),
            node_entity_ids=np.arange(100, 100 + s.num_nodes), node_embedding_ids=s.node_embedding_ids,
            start_entity_ids=100 + s.topic_locals, answer_entity_ids=100 + s.answer_locals,
            settings=AgentSettings(edge_top_k=30, max_hops=3, score_mode="logits"))
        if a is not None:
            out.append(a)
    out = out[:n]
    assert len(out) == n
    return out, [TAgentSample(**{f.name: getattr(a, f.name) for f in dataclasses.fields(a)}) for a in out]


@pytest.mark.parametrize("budget", [None, 0, 12, 40])
def test_triplet_records_match_jax(tiktoken_mode, budget):
    jsamples, tsamples = _agent_samples()
    kw = dict(window_k=(1, 3, 10, 50), token_budget=budget)
    for js, ts in zip(jsamples, tsamples):
        id2e = {int(i): f"ent {i}" for i in js.node_entity_ids}
        id2r = {int(r): f"rel.{r}" for r in np.unique(js.edge_relations)}
        args = dict(question_text=f"question {js.sample_id}?", gold_answers=["ent 101"], id2entity=id2e,
                    id2relation=id2r)
        want = jreasoner.build_triplet_records(js, settings=jreasoner.ReasonerSettings(**kw), **args)
        got = treasoner.build_triplet_records(ts, settings=treasoner.ReasonerSettings(**kw), **args)
        assert got == want
    if budget:
        assert all(r["evidence_token_count"] <= budget for r in got) and any(r["evidence_truncated"] for r in got)


def test_budget_truncation_matches_jax(tiktoken_mode):
    lines = [("token " * n).strip() for n in (10, 3, 7, 12, 1, 9, 4, 8)]
    for budget in (-1, 0, 1, 5, 10, 35, 60, 10_000):
        kw = dict(token_budget=budget, token_model="gpt-4o-mini")
        got = treasoner.select_visible_prefix_by_budget(lines, **kw)
        assert got == jreasoner.select_visible_prefix_by_budget(lines, **kw)
    n, tokens, trunc = treasoner.select_visible_prefix_by_budget(lines, token_budget=35, token_model="gpt-4o-mini")
    assert 0 < n < len(lines) and trunc and tokens <= 35
    assert treasoner.select_visible_prefix_by_budget([], token_budget=5, token_model="m") == (0, 0, False)


def test_path_records_and_hits_match_jax(tiktoken_mode):
    jsamples, tsamples = _agent_samples()
    for js, ts in zip(jsamples, tsamples):
        bfs = build_bfs_candidate_chains(
            num_nodes=js.num_nodes, heads=js.edge_head_locals, tails=js.edge_tail_locals,
            relations=js.edge_relations, scores=js.edge_scores, node_entity_ids=js.node_entity_ids,
            start_nodes=js.start_node_locals, settings=ChainSettings(max_chain_length=3))
        for c in bfs:
            c["chain_text"] = " -> ".join(str(e["edge_id"]) for e in c["chain_edges"])
        pairs = dict(pair_start_local=js.pair_start_local, pair_answer_local=js.pair_answer_local,
                     pair_shortest_len=js.pair_shortest_len)
        for c in bfs:
            assert treasoner.chain_is_shortest_hit(c, **pairs) == jreasoner.chain_is_shortest_hit(c, **pairs)
        for limit, meta in ((1, False), (5, True), (50, False)):
            kw = dict(path_limit=limit, include_chain_meta=meta)
            args = dict(sample_id=js.sample_id, question_text="q?", gold_answers=["x"], chains=bfs, **pairs)
            want = jreasoner.build_path_records(settings=jreasoner.ReasonerSettings(**kw), **args)
            assert treasoner.build_path_records(settings=treasoner.ReasonerSettings(**kw), **args) == want
    chain = chains_from_rollouts(actions_seqs=np.array([[0, -1, -1]]), directions_seqs=np.zeros((1, 3), int),
                                 heads=[0], tails=[1], relations=[0], scores=[1.0], node_entity_ids=[10, 11],
                                 max_chains=2)[0]
    assert treasoner.chain_is_shortest_hit(chain, pair_start_local=[0], pair_answer_local=[1], pair_shortest_len=[1])
    assert not treasoner.chain_is_shortest_hit(chain, pair_start_local=[0], pair_answer_local=[1],
                                               pair_shortest_len=[2])
    assert not treasoner.chain_is_shortest_hit({"chain_edges": []}, pair_start_local=[0], pair_answer_local=[1],
                                               pair_shortest_len=[1])


def test_run_reasoner_writes_what_jax_writes(tiktoken_mode, tmp_path):
    jsamples, tsamples = _agent_samples()
    settings = dict(window_k=(1, 10))
    recs = {}
    for pkg, mod, samples in (("jax", jreasoner, jsamples), ("port", treasoner, tsamples)):
        recs[pkg] = [r for s in samples for r in mod.build_triplet_records(
            s, question_text="q", gold_answers=["101"], id2entity={int(i): str(i) for i in s.node_entity_ids},
            id2relation={int(r): str(r) for r in np.unique(s.edge_relations)},
            settings=mod.ReasonerSettings(**settings))]
    assert recs["port"] == recs["jax"]
    for pkg, mod, client in (("jax", jreasoner, jclient), ("port", treasoner, tclient)):
        llm = client.init_llm(client.LLMConfig(model_name="mock", backend="mock", mock_response='{"answers": ["101"]}'))
        m = mod.run_reasoner(recs[pkg], mode="llm", llm=llm, output_path=tmp_path / pkg / "preds.jsonl")
        (tmp_path / pkg / "m.json").write_text(json.dumps(m, sort_keys=True))
    for name in ("preds.jsonl", "preds.jsonl.metrics.json", "m.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    oracle_inputs = [{"head_entity_ids": s.node_entity_ids[s.edge_head_locals],
                      "tail_entity_ids": s.node_entity_ids[s.edge_tail_locals],
                      "answer_entity_ids": s.answer_entity_ids} for s in jsamples]
    assert treasoner.run_reasoner([], mode="oracle", oracle_inputs=oracle_inputs) == \
        jreasoner.run_reasoner([], mode="oracle", oracle_inputs=oracle_inputs)
    with pytest.raises(ValueError, match="mode"):
        treasoner.run_reasoner([], mode="nope")


class _Resp(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_ollama_request_contract_matches_jax(monkeypatch):
    """POST /api/chat with the JAX package's payload (model without the
    ``ollama:`` prefix, messages, stream false, options), and a hard error
    on a body without message.content."""
    captured = {}

    def fake_urlopen(req, timeout=None):
        captured.setdefault("calls", []).append(dict(url=req.full_url, method=req.get_method(),
                                                     payload=json.loads(req.data.decode()), timeout=timeout,
                                                     headers=dict(req.header_items())))
        return _Resp(json.dumps({"message": {"content": "hi"}}).encode())

    cfg = dict(backend="ollama", model_name="ollama:llama3", temperature=0.25, max_tokens=77,
               frequency_penalty=0.5, ollama_base_url="http://127.0.0.1:9", ollama_timeout=3.0)
    msgs = [{"role": "system", "content": "s"}, {"role": "user", "content": "q"}]
    for mod in (jclient, tclient):
        monkeypatch.setattr(mod.request, "urlopen", fake_urlopen)
        assert mod.init_llm(mod.LLMConfig(**cfg))(msgs) == "hi"
    jcall, tcall = captured["calls"]
    assert tcall == jcall
    assert tcall["url"] == "http://127.0.0.1:9/api/chat" and tcall["method"] == "POST" and tcall["timeout"] == 3.0
    assert tcall["payload"] == {"model": "llama3", "messages": msgs, "stream": False,
                                "options": {"temperature": 0.25, "num_predict": 77, "frequency_penalty": 0.5}}
    monkeypatch.setattr(tclient.request, "urlopen",
                        lambda req, timeout=None: _Resp(json.dumps({"done": True}).encode()))
    with pytest.raises(ValueError, match="message.content"):
        tclient.init_llm(tclient.LLMConfig(**cfg))(msgs)


def test_retry_and_backoff(monkeypatch):
    sleeps = []
    monkeypatch.setattr(tclient.time, "sleep", sleeps.append)
    calls = []

    def flaky(messages):
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert tclient.run_chat(flaky, [], max_retries=3) == "ok"
    assert len(calls) == 3 and sleeps == [2, 4]

    def always(messages):
        raise RuntimeError("down")

    sleeps.clear()
    with pytest.raises(RuntimeError, match="down"):
        tclient.run_chat(always, [], max_retries=2)
    assert sleeps == [2, 4]

    def protocol(messages):
        calls.append(1)
        raise ValueError("bad body")  # not retryable

    calls.clear()
    with pytest.raises(ValueError):
        tclient.run_chat(protocol, [], max_retries=3)
    assert len(calls) == 1


@pytest.mark.parametrize("backend,package", [("openai", "openai"), ("vllm", "vllm"), ("auto", "openai"),
                                             ("auto", "vllm")])
def test_gated_backends_raise_as_jax_does(monkeypatch, backend, package):
    """Without the package the backend raises the JAX package's error; the
    ``auto`` backend picks openai for a "gpt" model, else vllm, and falls
    back to nothing."""
    monkeypatch.setitem(sys.modules, package, None)
    model = "gpt-4o-mini" if package == "openai" else "llama"
    errors = []
    for mod in (jclient, tclient):
        with pytest.raises(RuntimeError) as exc:
            mod.init_llm(mod.LLMConfig(model_name=model, backend=backend))
        errors.append(str(exc.value))
    assert errors[1] == errors[0] and f"backend='{package}' requires the {package} package" in errors[1]
    with pytest.raises(ValueError, match="unknown backend"):
        tclient.init_llm(tclient.LLMConfig(model_name="m", backend="nope"))

"""The reasoner cell (``drivers/reason.py``) and the long-subgraph serve
cell on the CPU at a tiny size: a whole run of ``moonlight.reason`` with a
tiny model and retriever is correct under the committed limits and its
readers report, the program runs the benchmark's own weights, the e4m3 control reads well above the sound run, a program
without the ``local`` backend stops before any other set-up, the FLOP and
byte counts of the published model, and ``cwq.serve``'s traffic gives only
m_pad 4,096 and 8,192 groups."""

import copy
import json

import numpy as np
import pytest
import torch

from benchmarks import gen, harness, llm_counts, llm_weights
from benchmarks.drivers import reason
from benchmarks.run import run_cell
from benchmarks.tests import tiny

SEED = 2_600_000_017
MODEL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
             vocab_size=512)


def _cell():
    c = harness.cell(harness.load_spec(), "moonlight.reason")
    cfg = copy.deepcopy(c["config"])
    cfg.update(MODEL)
    cfg["retriever"] = tiny.cell("webqsp.serve")["config"]
    cfg["names"]["pool"] = 256
    return dict(c, config=cfg, traffic=dict(c["traffic"], questions=4, answer_tokens=5))


@pytest.fixture(scope="module")
def ran():
    """One set-up, window and finish of the tiny cell."""
    c = _cell()
    st = reason.setup(c, SEED, torch.device("cpu"), harness.Spans())
    res = reason.window(st, 0.2, harness.Spans())
    reason.finish(st)
    return st, res


@pytest.mark.parametrize("trace", [0, 1])
def test_whole_run_is_correct_and_reports(trace):
    c = _cell()
    out = json.loads(run_cell(c, "moonlight.reason", SEED, 0.2, bool(trace), torch.device("cpu"),
                              log=lambda *a, **k: None))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert set(out["checks"]) == {"logit_err", "topk_gap", "route_gap"}
    if not trace:
        assert set(out["metrics"]) == {"serve_qps", "setup_s"}
    else:  # no device trace on the CPU: the readers of the program's counters report
        assert set(out["metrics"]) == {"reason.mfu", "reason.decode_roofline"}


def test_prompts_have_every_window_and_freebase_like_lines(ran):
    st, res = ran
    assert res["attempted"] % 4 == 0 and res["metrics"]["serve_qps"] > 0
    last = st["last"]
    assert len(last["prompts"]) == 4 and last["kept"].logits.shape == (4, 5, MODEL["vocab_size"])
    ents, rels = st["ents"], st["rels"]
    assert all(1 <= len(e.split()) <= 4 for e in ents[:500]) and all(r.count(".") == 2 for r in rels)


def test_the_program_runs_the_benchmarks_own_weights(ran):
    """Set-up copies the benchmark's draw over the program's own: every
    tensor the program holds is the benchmark's, no matrix is the
    program's draw, and the draw reads as its docstring says."""
    from evi_rag_tpu_torch.models.llm import moonlight
    from evi_rag_tpu_torch.models.llm.config import MoonlightConfig

    st, _ = ran
    w, mine = st["weights"], st["llm"].weights
    own = moonlight.init_weights(MoonlightConfig.from_dict(reason.model_config(st["cell"]["config"])), SEED, "cpu")
    assert set(mine) == set(w) == set(own)
    for k, t in w.items():
        assert torch.equal(mine[k], t.to(mine[k].dtype)), k
        assert torch.equal(t, w[k]), k  # drawn anew on each read, the same
        if t.dim() >= 2:
            assert not torch.equal(own[k].to(t.dtype), t), k
            assert 0.016 < float(t.float().std()) < 0.024, k
        elif k.endswith("norm"):
            assert abs(float(t.float().mean()) - 1) < 0.02 and 0.03 < float(t.float().std()) < 0.07, k
        else:
            assert t.dtype == torch.float32 and 0.02 < float(t.std()) < 0.1, k


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_a_program_whose_weights_differ_is_refused(fault):
    c = reason.model_config(_cell()["config"])
    w = llm_weights.MoonlightWeights(SEED, c, "cpu")
    mine = {k: torch.zeros(v) for k, v in w.layout.items()}
    if fault == "missing":
        del mine["layers.1.shared.down"]
    else:
        mine["layers.1.shared.down"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shared.down" if fault == "shape" else "differ in name"):
        reason.load(mine, w)


def test_the_e4m3_control_reads_well_above_the_sound_run(ran):
    """At this size the sound run is correct under the committed limits and
    the control reads several times higher on every number; the limits
    themselves come from the cell's own widths on the card (the control
    fails them there: ``python3 -m benchmarks.control``)."""
    st, _ = ran
    lim = harness.limits("moonlight.reason")
    sound, control = reason.readings(st), reason.readings(st, control=True)
    assert all(v <= lim[k] for k, v in sound.items()), sound
    assert all(control[k] > 3 * max(v, 1e-6) for k, v in sound.items()), (sound, control)


def test_a_program_without_the_local_backend_stops_first(monkeypatch):
    import evi_rag_tpu_torch.eval.llm_client as llm_client

    def refuse(cfg):
        raise ValueError(f"unknown backend {cfg.backend!r}")

    monkeypatch.setattr(llm_client, "init_llm", refuse)
    monkeypatch.setattr(reason.serve, "setup", lambda *a, **k: pytest.fail("served before the model"))
    with pytest.raises(ValueError, match="unknown backend"):
        reason.setup(_cell(), SEED, torch.device("cpu"), harness.Spans())


def test_counts_of_the_published_model():
    c = reason.model_config(harness.config("moonlight"))
    assert llm_counts.attention_params(c) == 13_762_560
    assert llm_counts.expert_params(c) == 8_650_752
    # ~2.24B matrix parameters a token below the LM head; ~15.96B in all.
    assert llm_counts.active_params(c) == 27 * 13_762_560 + 3 * 2048 * 11264 + 26 * (64 * 2048 + 8 * 8_650_752)
    one = dict(**{"reason.tokens.prefill": 10, "reason.sequences": 1, "reason.ctx.prefill": 55})
    assert llm_counts.flops(c, one) == pytest.approx(
        2 * llm_counts.active_params(c) * 10 + 2 * 163840 * 2048 + 55 * 27 * 16 * 2 * (192 + 128))
    step = {"moe.experts.touched": 26 * 64, "reason.tokens.decode": 48, "reason.ctx.decode": 48_000}
    moved = llm_counts.decode_bytes(c, step, 1)
    assert 31.0e9 < moved < 33.0e9  # every expert, the rest of the weights, ~1.5 GB of cache rows


def test_long_serve_traffic_takes_only_the_two_widest_buckets():
    c = harness.cell(harness.load_spec(), "cwq.serve")
    tr, g = c["traffic"], c["config"]["graph"]
    n = int(c["config"]["splits"][tr["split"]])
    counts = gen.edge_counts(n, float(g["lognorm_mean"]), float(g["lognorm_sigma"]), tr["edge_min"], tr["edge_max"],
                             tr["edge_rule"])
    assert counts.min() >= 2049 and counts.max() <= 6144
    rng = np.random.default_rng(0)
    for m in (int(counts.min()), int(counts.max())):
        q = gen.question(rng, m, 3, g)
        assert len(q["entities"]) + 1 <= 4096 and q["edge_index"].shape[1] == m
    pads = np.where(counts <= 4096, 4096, 8192)
    assert set(pads) == {4096, 8192} and 0.7 < float(np.mean(pads == 4096)) < 0.9

"""The Kimi-Linear reasoner cell (``drivers/reason_kimi.py``) on the CPU at a
tiny size: a whole run of ``kimi_linear.reason_long`` with a tiny model and
retriever is correct under the committed limits and its readers report,
the program runs the benchmark's own weights, the controls read as their
faults, a program without the model stops before any other set-up, and
the counts of the published model and its share of experts."""

import copy
import json

import pytest
import torch

from benchmarks import harness, kimi_counts, llm_weights_kimi
from benchmarks.drivers import reason_kimi
from benchmarks.run import run_cell
from benchmarks.tests import tiny

SEED = 2_600_000_029
MODEL = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=6,
             num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, num_experts=8, router_experts=16, num_experts_per_token=2,
             vocab_size=512)
LINEAR = dict(kda_layers=[1, 2, 3, 5], full_attn_layers=[4, 6], num_heads=4, head_dim=16)


def _cell():
    c = harness.cell(harness.load_spec(), "kimi_linear.reason_long")
    cfg = copy.deepcopy(c["config"])
    cfg.update(MODEL, retriever_k=16)
    cfg["linear_attn_config"].update(LINEAR)
    cfg["retriever"] = tiny.cell("webqsp.serve")["config"]
    cfg["names"]["pool"] = 256
    tr = dict(c["traffic"], questions=4, answer_tokens=5, windows=[4, 8, 12, 16], edge_min=17, edge_max=600)
    return dict(c, config=cfg, traffic=tr)


@pytest.fixture(scope="module")
def ran():
    """One set-up, window and finish of the tiny cell."""
    c = _cell()
    st = reason_kimi.setup(c, SEED, torch.device("cpu"), harness.Spans())
    res = reason_kimi.window(st, 0.2, harness.Spans())
    reason_kimi.finish(st)
    return st, res


@pytest.mark.parametrize("trace", [0, 1])
def test_whole_run_is_correct_and_reports(trace):
    c = _cell()
    out = json.loads(run_cell(c, "kimi_linear.reason_long", SEED, 0.2, bool(trace), torch.device("cpu"),
                              log=lambda *a, **k: None))
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert set(out["checks"]) == {"logit_err", "topk_gap", "route_gap", "state_err"}
    if not trace:
        assert set(out["metrics"]) == {"serve_qps", "setup_s"}
    else:  # no device trace on the CPU: the readers of the program's counters report
        assert set(out["metrics"]) == {"kimi.mfu", "kimi.decode_roofline"}


def test_the_program_runs_the_benchmarks_own_weights(ran):
    from evi_rag_tpu_torch.models.llm import kimi_linear
    from evi_rag_tpu_torch.models.llm.config import KimiLinearConfig

    st, res = ran
    assert res["attempted"] % 4 == 0 and res["metrics"]["serve_qps"] > 0
    w, mine = st["weights"], st["llm"].weights
    own = kimi_linear.init_weights(KimiLinearConfig.from_dict(reason_kimi.model_config(st["cell"]["config"])),
                                   SEED, "cpu")
    assert set(mine) == set(w) == set(own)
    for k, t in w.items():
        assert torch.equal(mine[k], t.to(mine[k].dtype)), k
        if t.dim() >= 2:
            assert not torch.equal(own[k].to(t.dtype), t), k
    a = w["layers.0.A_log"].exp()
    dt = torch.nn.functional.softplus(w["layers.0.dt_bias"])
    assert a.dtype == torch.float32 and 1 <= float(a.min()) and float(a.max()) <= 16
    assert 0.001 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-6
    assert st["last"]["kept"].states[0].shape == (4, 4, 16, 16)


def test_the_controls_read_as_their_faults(ran):
    """At this size the sound run is correct under the committed limits and
    the e4m3 control reads several times higher on every number.  The state
    control (the recurrence's state rounded to bf16 after every token) reads
    above the sound run on ``state_err`` (the first KDA layer's state, whose
    inputs are the same on both sides), though at these short prompts only
    just, and moves the logits less than the sound run's bf16 forward does;
    the limits come from the cell's own widths and lengths on the card
    (``python3 -m benchmarks.control``)."""
    st, _ = ran
    lim = harness.limits("kimi_linear.reason_long")
    sound, both = reason_kimi.readings(st), reason_kimi.readings(st, control=True)
    assert all(v <= lim[k] for k, v in sound.items()), sound
    assert set(both) == {f"{c}.{k}" for c in reason_kimi.CONTROLS for k in sound}
    assert all(both[f"e4m3.{k}"] > 3 * max(v, 1e-6) for k, v in sound.items()), (sound, both)
    assert sound["state_err"] < both["state_bf16.state_err"] and 1e-4 < both["state_bf16.logit_err"], (sound, both)


def test_a_program_without_the_model_stops_first(monkeypatch):
    import evi_rag_tpu_torch.eval.llm_client as llm_client

    def refuse(cfg):
        raise ValueError("model file: keys not implemented: ['linear_attn_config']")

    monkeypatch.setattr(llm_client, "init_llm", refuse)
    monkeypatch.setattr(reason_kimi.serve, "setup", lambda *a, **k: pytest.fail("served before the model"))
    with pytest.raises(ValueError, match="linear_attn_config"):
        reason_kimi.setup(_cell(), SEED, torch.device("cpu"), harness.Spans())


def test_counts_of_the_published_model_and_its_share():
    c = reason_kimi.model_config(harness.config("kimi_linear"))
    assert c["num_experts"] == 32 and c["router_experts"] == 256
    assert kimi_counts.layer_counts(c) == dict(kda=20, mla=7, dense=1, moe=26)
    assert kimi_counts.kda_params(c) == 4 * 2304 * 4096 + 3 * 4096 * 4 + 32 * 2304 + 2 * (128 * 2304 + 4096 * 128)
    layout = llm_weights_kimi.kimi_layout(c)
    held = sum(torch.Size(s).numel() for s in layout.values())
    assert 7.89e9 < held < 7.91e9  # this card's 7.90B parameters, 15.8 GB in bf16
    one = {"reason.tokens.prefill": 10, "reason.sequences": 1, "reason.ctx.prefill": 55, "moe.tokens.routed": 26 * 10,
           "kda.tokens.prefill": 200, "kda.states.prefill": 20}
    assert kimi_counts.flops(c, one) == pytest.approx(
        2 * kimi_counts.fixed_params(c) * 10 + 2 * 3 * 2304 * 1024 * 260 + 2 * 163840 * 2304
        + 55 * 7 * 32 * 2 * (192 + 128) + 200 * 4 * 32 * 128 * 128)
    step = {"moe.experts.touched": 26 * 32, "reason.tokens.decode": 128, "reason.ctx.decode": 128 * 9000,
            "kda.states.decode": 128 * 20, "kda.tokens.decode": 128 * 20}
    moved = kimi_counts.decode_bytes(c, step, 1)
    # every held expert 11.8 GB, latent rows at 9k positions 9.3 GB, KDA and conv states 11.1 GB, the rest 3.3 GB
    assert 35e9 < moved < 36e9
    # one decode step's recurrence: its recurrent and conv states read and written bound it
    assert kimi_counts.kda_bound_s(c, step) == pytest.approx(
        (128 * 20 * (5 * 4096 * 2 + 32 * 2) + 128 * 20 * 2 * (32 * 128 * 128 * 4 + 3 * 3 * 4096 * 2)) / 3.35e12)
    # a prefill chunk's: q, k, v, f and o in bf16 a token bound it
    chunk = {"kda.tokens.prefill": 20 * 27_000, "kda.states.prefill": 20 * 3}
    assert kimi_counts.kda_bound_s(c, chunk) == pytest.approx(
        (20 * 27_000 * (5 * 4096 * 2 + 32 * 2) + 20 * 3 * 2 * (32 * 128 * 128 * 4 + 3 * 3 * 4096 * 2)) / 3.35e12)

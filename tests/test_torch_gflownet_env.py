"""Port vs JAX: the GFlowNet env, reward and SubTB under forced actions.

Random walks pick each step's actions among the candidate edges (or STOP)
with numpy; both envs take the same actions.  Every field of the env state
must be equal at every step, the reward equal or within f32 rtol 1e-5, and
the closed-form SubTB within rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.models.gflownet import env as jenv
from evi_rag_tpu.models.gflownet import reward as jrew
from evi_rag_tpu.models.gflownet import subtb as jsub
from evi_rag_tpu_torch.models.gflownet import env as tenv
from evi_rag_tpu_torch.models.gflownet import reward as trew
from evi_rag_tpu_torch.models.gflownet import subtb as tsub

from _torch_gfn_common import agent_setup, to_np

H = 8


def _assert_states_equal(js, ts, where):
    for name in js.__dataclass_fields__:
        a, b = np.asarray(getattr(js, name)), to_np(getattr(ts, name))
        if name == "action_hidden":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f"{where} {name}")
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f"{where} {name}")


def _walk(seed, stop_on_answer, dummy):
    s = agent_setup(seed=seed, num_samples=10, count=4, dummy=dummy)
    max_steps = 3
    js = jenv.env_reset(s.jb, max_steps=max_steps, hidden_dim=H, stop_on_answer=stop_on_answer)
    ts = tenv.env_reset(s.tb, max_steps=max_steps, hidden_dim=H, stop_on_answer=stop_on_answer)
    _assert_states_equal(js, ts, "reset")
    rng = np.random.default_rng(seed + 100)
    g, eb = s.jb.graph.num_graphs, np.asarray(s.jb.graph.edge_batch)
    for t in range(max_steps + 1):
        jf, jbk = jenv.candidate_edge_masks(js, s.jb, max_steps=max_steps)
        tf, tbk = tenv.candidate_edge_masks(ts, s.tb, max_steps=max_steps)
        np.testing.assert_array_equal(to_np(tf), np.asarray(jf))
        np.testing.assert_array_equal(to_np(tbk), np.asarray(jbk))
        cand = (np.asarray(jf) | np.asarray(jbk)) & ~np.asarray(js.used_edge_mask)
        actions = np.full(g, jenv.STOP_ACTION, np.int32)
        for gi in range(g):
            opts = np.nonzero(cand & (eb == gi))[0]
            if opts.size and rng.random() < 0.85:
                actions[gi] = int(rng.choice(opts))
        if t == 1:
            actions[0] = int(np.nonzero(eb == 1)[0][0])  # another graph's edge: dropped
        emb = rng.normal(size=(g, H)).astype(np.float32)
        js = jenv.env_step(js, s.jb, jnp.asarray(actions), jnp.asarray(emb), step_index=t, max_steps=max_steps,
                           stop_on_answer=stop_on_answer)
        ts = tenv.env_step(ts, s.tb, torch.from_numpy(actions), torch.from_numpy(emb), step_index=t,
                           max_steps=max_steps, stop_on_answer=stop_on_answer)
        _assert_states_equal(js, ts, f"step {t}")
    return s, js, ts


@pytest.mark.parametrize("dummy", [False, True])
@pytest.mark.parametrize("stop_on_answer", [False, True])
@pytest.mark.parametrize("seed", [0, 3, 5])
def test_env_walk_and_reward_match_jax(seed, stop_on_answer, dummy):
    s, js, ts = _walk(seed, stop_on_answer, dummy)
    cfg = dict(success_reward=1.0, failure_reward=1e-3, semantic_coef=0.7, length_coef=0.5)
    kw = lambda st: dict(selected_mask=st.used_edge_mask, answer_hit=st.answer_hits,  # noqa: E731
                         start_node_hit=st.start_node_hit, answer_node_hit=st.answer_node_hit)
    jr = jrew.compute_reward(s.jb, config=jrew.RewardConfig(**cfg), **kw(js))
    tr = trew.compute_reward(s.tb, config=trew.RewardConfig(**cfg), **kw(ts))
    for name in jr.__dataclass_fields__:
        np.testing.assert_allclose(to_np(getattr(tr, name)), np.asarray(getattr(jr, name)), rtol=1e-5, atol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(
        to_np(trew.match_shortest_lengths(s.tb, ts.start_node_hit, ts.answer_node_hit)),
        np.asarray(jrew.match_shortest_lengths(s.jb, js.start_node_hit, js.answer_node_hit)))


def test_reward_config_validation_matches_jax():
    for bad in (dict(success_reward=0.0), dict(success_reward=1e-5), dict(length_coef=-1.0)):
        for lib in (jrew, trew):
            with pytest.raises(ValueError):
                lib.RewardConfig(**bad)


@pytest.mark.parametrize("seed", range(4))
def test_subtb_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g, t = 6, 4
    log_pf = rng.normal(size=(g, t)).astype(np.float32)
    log_flow = rng.normal(size=(g, t)).astype(np.float32)
    log_r = rng.normal(size=g).astype(np.float32)
    lengths = rng.integers(-1, t + 2, size=g).astype(np.int32)
    mask = rng.random(g) < 0.7
    jflows = jsub.log_flow_with_terminal_reward(jnp.asarray(log_flow), jnp.asarray(log_r), jnp.asarray(lengths))
    tflows = tsub.log_flow_with_terminal_reward(torch.from_numpy(log_flow), torch.from_numpy(log_r),
                                                torch.from_numpy(lengths))
    np.testing.assert_array_equal(to_np(tflows), np.asarray(jflows))
    for gm in (None, mask):
        want = jsub.subtb_loss(jflows, jnp.asarray(log_pf), jnp.asarray(lengths),
                               graph_mask=None if gm is None else jnp.asarray(gm))
        got = tsub.subtb_loss(tflows, torch.from_numpy(log_pf), torch.from_numpy(lengths),
                              graph_mask=None if gm is None else torch.from_numpy(gm))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="shape"):
        tsub.subtb_loss(tflows[:, :-1], torch.from_numpy(log_pf), torch.from_numpy(lengths))


@pytest.mark.parametrize("kw", [dict(bc_weight=0.0), dict(bc_weight=0.5), dict(bc_weight=1.0, hold_steps=10),
                                dict(bc_weight=1.0, hold_steps=10, decay_steps=10),
                                dict(bc_weight=0.8, bc_weight_floor=0.2, hold_steps=3, decay_steps=17)])
def test_bc_weight_schedule_matches_jax(kw):
    for step in (0, 1, 5, 10, 13, 15, 20, 40):
        got = tsub.bc_weight_schedule(torch.tensor(step, dtype=torch.int32), **kw)
        np.testing.assert_allclose(got.item(), float(jsub.bc_weight_schedule(step, **kw)), rtol=1e-6, atol=1e-7)

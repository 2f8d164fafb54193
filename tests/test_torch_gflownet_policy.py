"""Port vs JAX: the GFlowNet embedder, state encoder, policy and rollout.

* The frozen embedder in both edge modes: f32 rtol 1e-4 / atol 1e-5.
* The policy: ``precompute_steps`` + ``apply_precomputed`` against the
  canonical step, and each against JAX, at f32 (with JAX's dropout masks in
  train mode) and at bf16 (the bf16 rounding's tolerance).
* Rollouts: sampled with JAX's Gumbel uniforms (and dropout masks), greedy
  at init (every edge logit ties: the lowest edge index wins), forced
  replay, the canonical per-step policy, BC statistics and remat: actions
  equal, ``log_pf`` rtol 1e-4 / atol 1e-5, ``state_emb_seq`` rtol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.models.gflownet import actor as jactor
from evi_rag_tpu.models.gflownet import embedder as jemb
from evi_rag_tpu.models.gflownet.policy import GFlowNetEdgePolicy as JPolicy
from evi_rag_tpu.train import gflownet_trainer as jgt
from evi_rag_tpu_torch.models.gflownet import actor as tactor
from evi_rag_tpu_torch.models.gflownet import embedder as temb
from evi_rag_tpu_torch.models.gflownet.policy import GFlowNetEdgePolicy as TPolicy
from evi_rag_tpu_torch.train import gflownet_trainer as tgt

from _torch_gfn_common import (
    EMB, F32, GRAD_TOL, agent_setup, configs, jax_dropout_masks, perturbed_params, port_modules,
    rollout_draws, to_np)


@pytest.fixture(scope="module")
def setup():
    return agent_setup()


def _esp(mods):
    return {"kernel": mods.edge_score_proj.kernel, "bias": mods.edge_score_proj.bias}


def test_embedder_geometry_matches_jax(setup):
    s = setup
    want = jemb.embed_agent_batch_frozen(s.jbundle, s.jb)
    got = temb.embed_agent_batch_frozen(s.tbundle, s.tb)
    for name in ("edge_tokens", "node_tokens", "question_tokens"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name, **F32)
    rng = np.random.default_rng(0)
    esp = {"kernel": rng.normal(size=(1, EMB)).astype(np.float32), "bias": rng.normal(size=EMB).astype(np.float32)}
    want = jemb.embed_agent_batch(s.jbundle, s.jb, edge_score_proj=jax.tree.map(jnp.asarray, esp))
    got = temb.embed_agent_batch(s.tbundle, s.tb, edge_score_proj={k: torch.from_numpy(v) for k, v in esp.items()})
    np.testing.assert_allclose(to_np(got.edge_tokens), np.asarray(want.edge_tokens), **F32)
    zero = temb.init_edge_score_proj(EMB)
    assert float(zero["kernel"].abs().sum() + zero["bias"].abs().sum()) == 0.0


def test_embedder_concat_mode_matches_jax(setup):
    s = setup
    rng = np.random.default_rng(4)
    h, sd = EMB, 2 * 2 * (1 + 2 + 2)
    adapter = {"dense_0": {"kernel": rng.normal(size=(4 * h + sd, h)), "bias": rng.normal(size=h)},
               "norm": {"scale": 1 + 0.1 * rng.normal(size=h), "bias": 0.1 * rng.normal(size=h)},
               "dense_1": {"kernel": rng.normal(size=(h, h)), "bias": rng.normal(size=h)}}
    adapter = jax.tree.map(lambda x: np.asarray(x, np.float32), adapter)
    feats = {k: s.bundle_np["features"][k] for k in ("entity_proj", "relation_proj", "query_proj",
                                                      "non_text_entity_emb")}
    bundle = {"edge_mode": "concat", "parity_meta": s.bundle_np["parity_meta"],
              "features": {**feats, "edge_adapter": adapter}}
    want = jemb.embed_agent_batch_frozen({**bundle, "features": jax.tree.map(jnp.asarray, bundle["features"])}, s.jb)
    got = temb.embed_agent_batch_frozen(tgt.bundle_on(bundle, torch.device("cpu")), s.tb)
    np.testing.assert_allclose(to_np(got.edge_tokens), np.asarray(want.edge_tokens), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="edge_mode"):
        temb.embed_agent_batch_frozen({**tgt.bundle_on(bundle, torch.device("cpu")), "edge_mode": "x"}, s.tb)


def _policy_inputs(s, seed=0):
    rng = np.random.default_rng(seed)
    e, g = s.jb.graph.num_edges, s.jb.graph.num_graphs
    tokens = rng.normal(size=(e, EMB)).astype(np.float32)
    state = rng.normal(size=(g, EMB)).astype(np.float32)
    valid = np.asarray(s.jb.graph.edge_mask) & (rng.random(e) < 0.7)
    return tokens, state, valid


def _policy_params(s, seed=0):
    jcfg, _ = configs()
    return perturbed_params(jcfg, jgt.build_modules(jcfg), s, seed=seed)["policy"]


@pytest.mark.parametrize("train", [False, True])
def test_policy_matches_jax_f32(setup, train):
    s = setup
    params = _policy_params(s)
    tokens, state, valid = _policy_inputs(s)
    dropout = 0.3 if train else 0.0
    jp = JPolicy(hidden_dim=EMB, dropout=dropout)
    tp = TPolicy(EMB, dropout=dropout)
    tgt.load_gflownet_params(_Wrap(tp), {"policy": params})
    eb = s.jb.graph.edge_batch
    steps, key = 3, jax.random.key(11)
    jst = jp.apply(params, jnp.asarray(tokens), steps, train=train, method=JPolicy.precompute_steps,
                   rngs={"dropout": jax.random.fold_in(key, 987)} if train else None)
    masks = jax_dropout_masks(params, key, steps, len(eb), EMB, dropout) if train else (None, None)
    with torch.no_grad():
        tst = tp.precompute_steps(torch.from_numpy(tokens), steps, train=train,
                                  keep_edge=None if masks[0] is None else torch.from_numpy(masks[0]),
                                  keep_head=None if masks[1] is None else torch.from_numpy(masks[1]))
        for name in ("k", "v", "p_edge", "sum_e", "sumsq_e"):
            np.testing.assert_allclose(to_np(getattr(tst, name)), np.asarray(getattr(jst, name)), err_msg=name, **F32)
        for t in range(steps):
            jt = jax.tree.map(lambda x: x[t], jst)
            want = jp.apply(params, jt, jnp.asarray(state), eb, jnp.asarray(valid), method=JPolicy.apply_precomputed)
            got = tp.apply_precomputed(tst.at(t), torch.from_numpy(state), torch.from_numpy(np.asarray(eb)),
                                       torch.from_numpy(valid))
            for a, b, name in zip(got, want, ("edge", "stop", "state_out")):
                np.testing.assert_allclose(to_np(a), np.asarray(b), err_msg=f"step {t} {name}", **F32)
        if not train:  # the canonical step is the same function
            want = jp.apply(params, jnp.asarray(tokens), jnp.asarray(state), eb, jnp.asarray(valid))
            got = tp(torch.from_numpy(tokens), torch.from_numpy(state), torch.from_numpy(np.asarray(eb)),
                     torch.from_numpy(valid))
            pre = tp.apply_precomputed(tst.at(0), torch.from_numpy(state), torch.from_numpy(np.asarray(eb)),
                                       torch.from_numpy(valid))
            for a, b, c in zip(got, want, pre):
                np.testing.assert_allclose(to_np(a), np.asarray(b), **F32)
                np.testing.assert_allclose(to_np(c), to_np(a), **F32)


def test_policy_bf16_follows_flax_dtype_rules(setup):
    s = setup
    params = _policy_params(s)
    tokens, state, valid = _policy_inputs(s, seed=1)
    jp = JPolicy(hidden_dim=EMB, dropout=0.0, compute_dtype="bfloat16")
    tp = TPolicy(EMB, dropout=0.0, compute_dtype="bfloat16")
    tgt.load_gflownet_params(_Wrap(tp), {"policy": params})
    eb = s.jb.graph.edge_batch
    jst = jp.apply(params, jnp.asarray(tokens), 2, method=JPolicy.precompute_steps)
    want = jp.apply(params, jax.tree.map(lambda x: x[0], jst), jnp.asarray(state), eb, jnp.asarray(valid),
                    method=JPolicy.apply_precomputed)
    with torch.no_grad():
        tst = tp.precompute_steps(torch.from_numpy(tokens), 2)
        assert tst.k.dtype == tst.p_edge.dtype == torch.bfloat16 and tst.sum_e.dtype == torch.float32
        got = tp.apply_precomputed(tst.at(0), torch.from_numpy(state), torch.from_numpy(np.asarray(eb)),
                                   torch.from_numpy(valid))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        fa, fb = to_np(a), np.asarray(b)
        m = fb > -1e30
        np.testing.assert_allclose(fa[m], fb[m], rtol=2e-2, atol=2e-2)


class _Wrap(torch.nn.Module):
    """A lone policy under the name ``policy`` (for ``load_gflownet_params``)."""

    def __init__(self, policy):
        super().__init__()
        self.policy = policy


def _rollouts(s, jcfg, tcfg, params, *, key, train=False, greedy=False, forced=None, bc=False, remat=False):
    jm = jgt.build_modules(jcfg)
    tm = port_modules(tcfg, params)
    jp = jax.tree.map(jnp.asarray, params)
    jembed = jemb.embed_agent_batch(s.jbundle, s.jb, edge_score_proj=jp["edge_score_proj"])
    tembed = temb.embed_agent_batch(s.tbundle, s.tb, edge_score_proj=_esp(tm))
    dag = (s.jb.edge_labels > 0.5) & s.jb.graph.edge_mask if bc else None
    want = jactor.rollout(policy=jm.policy, state_encoder=jm.state_encoder, policy_params=jp["policy"],
                          encoder_params=jp["state_encoder"], batch=s.jb, embed=jembed, rng=key,
                          config=jcfg.actor, greedy=greedy, forced_actions=forced, dag_edge_mask=dag, train=train)
    sample = forced is None and not greedy and jcfg.policy_temperature >= 1e-5
    draws = rollout_draws([key], s.jb, jcfg.actor.num_steps, EMB, dropout=jcfg.dropout if train else 0.0,
                          policy_params=jp["policy"], sample=sample)
    tcfg_actor = dataclasses.replace(tcfg.actor, remat_policy=remat)
    got = tactor.rollout(policy=tm.policy, state_encoder=tm.state_encoder, batch=s.tb, embed=tembed,
                         config=tcfg_actor, greedy=greedy,
                         forced_actions=None if forced is None else torch.from_numpy(np.asarray(forced)),
                         dag_edge_mask=None if dag is None else torch.from_numpy(np.asarray(dag)),
                         train=train, draws=draws)
    return want, got, tm


def _assert_rollouts_equal(want, got):
    for name in ("actions_seq", "directions_seq", "selected_mask", "selection_order", "answer_node_hit",
                 "start_node_hit", "active_nodes", "answer_hits", "length", "reach_success"):
        np.testing.assert_array_equal(to_np(got[name]), np.asarray(want[name]).astype(to_np(got[name]).dtype),
                                      err_msg=name)
    for name in ("log_pf", "log_pf_steps"):
        np.testing.assert_allclose(to_np(got[name]), np.asarray(want[name]), rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(to_np(got["state_emb_seq"]), np.asarray(want["state_emb_seq"]), rtol=1e-4,
                               atol=1e-5)
    for name in ("bc_loss_per_graph", "bc_steps_per_graph", "bc_has_dag"):
        if name in want:
            np.testing.assert_allclose(to_np(got[name]), np.asarray(want[name]), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", ["sampled", "sampled_dropout", "sampled_bc", "canonical", "temperature"])
def test_sampled_rollout_with_jax_draws_matches_jax(setup, case):
    s = setup
    kw = dict(dropout=0.2) if case == "sampled_dropout" else {}
    if case == "canonical":
        kw["precompute_policy"] = False
    if case == "temperature":
        kw["policy_temperature"] = 0.5
    jcfg, tcfg = configs(max_steps=3, stop_on_answer=False, **kw)
    params = perturbed_params(jcfg, jgt.build_modules(jcfg), s, seed=2)
    for i in range(3):
        want, got, _ = _rollouts(s, jcfg, tcfg, params, key=jax.random.key(20 + i), train=case == "sampled_dropout",
                                 bc=case == "sampled_bc")
        _assert_rollouts_equal(want, got)
    assert (np.asarray(want["actions_seq"]) >= 0).any()


def test_greedy_rollout_at_init_breaks_ties_by_lowest_edge(setup):
    """At init the edge head is zero: every valid edge's logit ties.  With
    the stop bias lowered the greedy policy takes edges, the lowest valid
    edge index of each graph; at plain init every graph stops at once."""
    s = setup
    jcfg, tcfg = configs(max_steps=3, stop_on_answer=False)
    params = jax.tree.map(np.asarray, jgt.init_gflownet_params(jcfg, jgt.build_modules(jcfg), s.jbundle, s.jb))
    want, got, _ = _rollouts(s, jcfg, tcfg, params, key=jax.random.key(0), greedy=True)
    _assert_rollouts_equal(want, got)
    assert (to_np(got["actions_seq"]) == -1).all()
    params["policy"]["params"]["stop_head_1"]["bias"] = np.full((1,), -3.0, np.float32)
    want, got, _ = _rollouts(s, jcfg, tcfg, params, key=jax.random.key(0), greedy=True)
    _assert_rollouts_equal(want, got)
    acts = to_np(got["actions_seq"])
    eb, emask = np.asarray(s.jb.graph.edge_batch), np.asarray(s.jb.graph.edge_mask)
    start = np.asarray(s.jb.node_is_start)
    heads, tails = np.asarray(s.jb.graph.heads), np.asarray(s.jb.graph.tails)
    for g in range(len(s.samples)):
        incident = np.nonzero((eb == g) & emask & (start[heads] | start[tails]))[0]
        if incident.size and not bool(np.asarray(s.jb.is_dummy)[g]):
            assert acts[g, 0] == incident.min(), g


def test_forced_rollout_replays_jax_actions(setup):
    s = setup
    jcfg, tcfg = configs(max_steps=3, stop_on_answer=False)
    params = perturbed_params(jcfg, jgt.build_modules(jcfg), s, seed=3)
    free, _, _ = _rollouts(s, jcfg, tcfg, params, key=jax.random.key(5))
    want, got, _ = _rollouts(s, jcfg, tcfg, params, key=jax.random.key(6), forced=free["actions_seq"], bc=True)
    _assert_rollouts_equal(want, got)
    np.testing.assert_array_equal(to_np(got["actions_seq"]), np.asarray(free["actions_seq"]))
    np.testing.assert_allclose(to_np(got["log_pf"]), np.asarray(free["log_pf"]), rtol=1e-4, atol=1e-5)


def test_remat_recomputes_the_same_rollout(setup):
    """``remat_policy=True``: the same forward bit for bit and the same
    gradients (the dropout masks are drawn outside the checkpoint)."""
    s = setup
    jcfg, tcfg = configs(max_steps=3, stop_on_answer=False, dropout=0.2)
    params = perturbed_params(jcfg, jgt.build_modules(jcfg), s, seed=4)
    outs = []
    for remat in (False, True):
        tm = port_modules(tcfg, params)
        tembed = temb.embed_agent_batch(s.tbundle, s.tb, edge_score_proj=_esp(tm))
        draws = rollout_draws([jax.random.key(9)], s.jb, 4, EMB, dropout=0.2,
                              policy_params=jax.tree.map(jnp.asarray, params["policy"]))
        ro = tactor.rollout(policy=tm.policy, state_encoder=tm.state_encoder, batch=s.tb, embed=tembed,
                            config=dataclasses.replace(tcfg.actor, remat_policy=remat), train=True, draws=draws)
        (ro["log_pf"].sum() + ro["state_emb_seq"].square().sum()).backward()
        outs.append((to_np(ro["log_pf"]), {n: p.grad.clone() for n, p in tm.named_parameters() if p.grad is not None}))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[0][1].keys() == outs[1][1].keys() and outs[0][1]
    for k, g in outs[0][1].items():
        np.testing.assert_allclose(to_np(outs[1][1][k]), to_np(g), err_msg=k, **GRAD_TOL)


def test_log_probs_edges_matches_jax():
    rng = np.random.default_rng(0)
    e, g = 40, 5
    eb = np.sort(rng.integers(0, g, size=e)).astype(np.int32)
    valid = rng.random(e) < 0.6
    valid[eb == 2] = False  # a graph with no valid edge
    logits = rng.normal(size=e).astype(np.float32)
    stop = rng.normal(size=g).astype(np.float32)
    for temp in (1.0, 0.3, 0.0):
        want = jactor.log_probs_edges(jnp.asarray(logits), jnp.asarray(stop), jnp.asarray(eb), jnp.asarray(valid), g,
                                      temp)
        got = tactor.log_probs_edges(torch.from_numpy(logits), torch.from_numpy(stop), torch.from_numpy(eb),
                                     torch.from_numpy(valid), g, temp)
        for a, b in zip(got, want):
            np.testing.assert_allclose(to_np(a), np.asarray(b).astype(to_np(a).dtype), rtol=1e-5, atol=1e-5)


def test_state_encoder_matches_jax(setup):
    """``encode_state`` and ``encode_states_batched`` with the state-DDE
    term on, from the same parameters and env snapshots."""
    from evi_rag_tpu.models.gflownet import env as jenv
    from evi_rag_tpu.models.gflownet.state_encoder import StateEncoder as JEncoder
    from evi_rag_tpu_torch.models.gflownet import env as tenv

    s = setup
    jcfg, tcfg = configs(max_steps=3, use_state_dde=True)
    params = perturbed_params(jcfg, jgt.build_modules(jcfg), s, seed=6)
    tm = port_modules(tcfg, params)
    je = JEncoder(hidden_dim=EMB, max_steps=3, use_state_dde=True)
    jp = jax.tree.map(jnp.asarray, params["state_encoder"])
    rng = np.random.default_rng(0)
    n, g = s.jb.graph.num_nodes, s.jb.graph.num_graphs
    nodes = rng.normal(size=(n, EMB)).astype(np.float32)
    questions = rng.normal(size=(g, EMB)).astype(np.float32)
    jcache = je.apply(jp, s.jb, node_tokens=jnp.asarray(nodes), question_tokens=jnp.asarray(questions),
                      method=JEncoder.precompute)
    with torch.no_grad():
        tcache = tm.state_encoder.precompute(s.tb, node_tokens=torch.from_numpy(nodes),
                                             question_tokens=torch.from_numpy(questions))
        jstate = jenv.env_reset(s.jb, max_steps=3, hidden_dim=EMB)
        tstate = tenv.env_reset(s.tb, max_steps=3, hidden_dim=EMB)
        want = je.apply(jp, jcache, jstate, s.jb, method=JEncoder.encode_state)
        np.testing.assert_allclose(to_np(tm.state_encoder.encode_state(tcache, tstate, s.tb)), np.asarray(want), **F32)
        active = rng.random((4, n)) < 0.3
        counts = rng.integers(0, 4, size=(4, g)).astype(np.int32)
        hidden = rng.normal(size=(4, g, EMB)).astype(np.float32)
        want = je.apply(jp, jcache, s.jb, active_seq=jnp.asarray(active), counts_seq=jnp.asarray(counts),
                        action_hidden_seq=jnp.asarray(hidden), method=JEncoder.encode_states_batched)
        got = tm.state_encoder.encode_states_batched(tcache, s.tb, active_seq=torch.from_numpy(active),
                                                     counts_seq=torch.from_numpy(counts),
                                                     action_hidden_seq=torch.from_numpy(hidden))
        np.testing.assert_allclose(to_np(got), np.asarray(want), **F32)

"""The reference against the port at a small width on the CPU (the test
imports both; the reference imports nothing of the port), and the control
one precision step down reading well above the port."""

import numpy as np
import pytest
import torch

from benchmarks import gen, harness
from benchmarks.drivers.common import samples
from benchmarks.reference import model as ref, train as ref_train
from benchmarks.tests import tiny

SEED = 2_600_000_003


def _bundle(P):
    return {"features": P}


def test_scores_agree_with_the_port_scorers():
    from evi_rag_tpu_torch.ops.query import query_topk_per_question
    from evi_rag_tpu_torch.ops.score_kernels import per_question_scores_reference
    from evi_rag_tpu_torch.serving import edge_struct_features, project_tables

    c = tiny.cell("webqsp.serve")
    g = c["config"]["graph"]
    qs = gen.split(SEED, 6, g)
    ss = samples(qs, gen.nontext_flags(SEED, g), "t")
    ent, rel, qtab = gen.tables(SEED, g, 64, 6, "cpu")
    P = gen.weights(SEED, 64, 64, 20, "cpu")
    pe, pr = project_tables(_bundle(P), ent.numpy(), rel.numpy(), device="cpu")
    bf = ref.Prec("bfloat16")
    with torch.no_grad():
        assert torch.allclose(pe, ref.entity_rows(P, ent, torch.arange(ent.shape[0])), atol=1e-6)
        for i, (q, s) in enumerate(zip(qs, ss)):
            want = ref.question_scores(P, q, (ent, rel, qtab), i, bf)
            ei = torch.as_tensor(s.edge_index).long()
            e, n = ei.shape[1], s.num_nodes
            topic = torch.zeros(1, n, 2)
            topic[0, :, 1] = 1.0
            topic[0, s.topic_locals, 0], topic[0, s.topic_locals, 1] = 1.0, 0.0
            st = edge_struct_features(topic, ei[None], torch.ones(1, e, dtype=torch.bool), num_rounds=2,
                                      num_reverse_rounds=2)
            rows = torch.as_tensor(s.node_embedding_ids).long()
            h, t = pe[rows][ei[0]][None], pe[rows][ei[1]][None]
            r = pr[torch.as_tensor(s.edge_relations).long()][None]
            kernel = per_question_scores_reference(_bundle(P), qtab[i][None], h, r, t, st,
                                                   torch.tensor([e], dtype=torch.int32))[0]
            v, ids = query_topk_per_question(_bundle(P), qtab[i][None], h, r, t, st, torch.ones(1, e, dtype=torch.bool),
                                             k=e)
            plain = torch.empty(e).index_copy_(0, ids[0].long(), v[0])
            # bf16 operands rounded at other points: a few bf16 steps of z, on scores of O(0.1) here
            assert float((kernel - want).abs().max()) < 0.01
            assert float((plain - want).abs().max()) < 0.01


@pytest.mark.parametrize("workload", ["webqsp.serve", "cwq.pooled", "cwq.train"])
def test_control_reads_well_above_the_port(workload):
    c = tiny.cell(workload)
    drv = harness.driver(c["traffic"]["kind"])
    st = drv.setup(c, SEED, torch.device("cpu"), harness.Spans())
    drv.window(st, 0.2, harness.Spans())
    drv.finish(st)
    sound, control = drv.readings(st), drv.readings(st, control=True)
    assert any(control[k] > 3 * max(sound[k], 1e-6) for k in sound), (sound, control)
    assert all(np.isfinite(v) for v in list(sound.values()) + list(control.values()))


def _other_order(st):
    order = np.arange(st["n"])
    np.random.default_rng(1).shuffle(order)
    b = st["batch"]
    return [list(order[i * b:(i + 1) * b]) for i in range(len(st["losses"]))]


# How the reference replays the program's first steps, and departures from it.
REPLAY = {"another_batch_order": dict(steps=_other_order),
          "another_bucket": dict(bucket=lambda st: 2 * st["bucket_edges"]),
          "another_generator": dict(seed=lambda st: st["draw_seed"] + 1)}


@pytest.mark.parametrize("departure", sorted(REPLAY))
def test_training_comparison_replays_the_programs_draws_and_order(departure):
    """The training comparison replays the program's random draws and batch
    order (PERF.md, section 2): per step a keep mask ``[E_slots, H]`` for each
    direction, then ``[E_slots]`` hide-and-seek uniforms, from the state's
    generator, ``E_slots`` the one fixed bucket's edge slots that every batch
    carries, real edges from slot 0; epoch 0 in ``default_rng(0)``'s shuffle.
    The program's first steps agree with that replay, and a replay that
    departs from it in one of these reads past the cell's limits: so a change
    to the program's draws, bucket or order fails here, before a chip run."""
    from benchmarks.drivers import train

    c = tiny.cell("cwq.train")
    st = train.setup(c, SEED, torch.device("cpu"), harness.Spans())
    assert all(next(st["feed"]).graph.edge_mask.shape[-1] == st["bucket_edges"] for _ in range(3))
    train.finish(st)
    st["draw_seed"] = train.draw_seed(SEED)
    lim = harness.limits("cwq.train")
    v = REPLAY[departure]
    run = lambda steps, bucket, seed: ref_train.run(  # noqa: E731
        c["config"], st["P"], st["qs"], st["tables"], steps, ref.Prec("bfloat16"), seed, bucket)
    with ref.exact_f32():
        want = run(train.steps_samples(st), st["bucket_edges"], st["draw_seed"])
        other = run(v.get("steps", train.steps_samples)(st), v.get("bucket", lambda s: s["bucket_edges"])(st),
                    v.get("seed", lambda s: s["draw_seed"])(st))
    sound = train.gaps(dict(losses=st["losses"], first_grad=st["first_grad"], change=st["change"]), want)
    departed = train.gaps(other, want)
    print(departure, sound, departed)
    assert all(x <= lim[k] for k, x in sound.items()), sound
    assert any(x > lim[k] for k, x in departed.items()), departed

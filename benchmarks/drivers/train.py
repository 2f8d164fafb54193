"""Train driver: retriever training steps (``train.retriever_trainer.
make_train_step``, AdamW by the configuration) on batches from the port's
feeder (``data.feeder.iter_stacked_batches``, id feed, pinned, one fixed
bucket, ``prefetch``), fed as ``fit`` feeds them, epoch after epoch,
without its evaluation and checkpoints.

Set-up builds the one training state, loads the benchmark's weights into
it, gives it the benchmark's generator for its random draws and drives it
through the first ``first_steps`` steps by the window's own feed and call;
the window continues the same state.  Those steps are what the comparison
reads: each step's loss, the first gradient as the optimizer holds it (its
first moment after one step, over 1 - b1) and each parameter's change over
them (copied before the window moves it again).

Traffic keys: ``split`` (its size in the configuration is the question
count), ``batch`` (graphs a step), ``first_steps``.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from benchmarks import gen
from benchmarks.drivers import common
from benchmarks.reference import compare, model as ref, train as ref_train


def _configs(cfg: dict):
    from evi_rag_tpu_torch.models.losses import RetrieverLossConfig
    from evi_rag_tpu_torch.models.retriever import Retriever
    from evi_rag_tpu_torch.train.optim import OptimizerConfig
    from evi_rag_tpu_torch.train.retriever_trainer import RetrieverTrainConfig

    m, t = cfg["model"], cfg["train"]
    hs, o = m["hide_seek"], t["optimizer"]
    model = Retriever(
        emb_dim=int(m["emb_dim"]), hidden_dim=int(m["hidden_dim"]), dde_rounds=int(m["dde_rounds"]),
        dde_reverse_rounds=int(m["dde_reverse_rounds"]), dropout_p=float(m["dropout_p"]),
        direction_mode=m["direction_mode"], compute_dtype=m["compute_dtype"],
        hide_seek_enabled=bool(hs["enabled"]), hide_seek_p_near=float(hs["p_near"]),
        hide_seek_p_far=float(hs["p_far"]), hide_seek_bias_near=float(hs["bias_near"]),
        hide_seek_bias_far=float(hs["bias_far"]))
    tcfg = RetrieverTrainConfig(
        loss=RetrieverLossConfig(infonce_temperature=float(t["infonce_temperature"])),
        optimizer=OptimizerConfig(name=o["name"], learning_rate=float(o["learning_rate"]),
                                  b1=float(o["b1"]), b2=float(o["b2"]),
                                  weight_decay=float(o["weight_decay"]), grad_clip_norm=float(o["grad_clip_norm"]),
                                  schedule=o["schedule"], warmup_steps=int(o["warmup_steps"]),
                                  total_steps=int(o["total_steps"])))
    return model, tcfg


def draw_seed(seed: int) -> int:
    return (int(seed) * 15485863 + 5) % (1 << 62)


def setup(cell: dict, seed: int, device: torch.device, spans) -> dict:
    from evi_rag_tpu_torch.data.feeder import fixed_bucket_for, iter_stacked_batches, prefetch
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.models.retriever import load_params, params_tree
    from evi_rag_tpu_torch.train.checkpoint import flatten_tree
    from evi_rag_tpu_torch.train.optim import setup_optimizer
    from evi_rag_tpu_torch.train.retriever_trainer import TrainState, make_train_step

    cfg, tr = cell["config"], cell["traffic"]
    g = cfg["graph"]
    d, h, s, _ = common.model_dims(cfg)
    n = int(cfg["splits"][tr["split"]])
    batch = int(tr["batch"])
    with spans("setup.graphs"):
        qs = gen.split(seed, n, g, stream=2)
        samples = common.samples(qs, gen.nontext_flags(seed, g), tr["split"])
    with spans("setup.tables"):
        ent, rel, qtab = gen.tables(seed, g, d, n, device, stream=2)
        P = gen.weights(seed, d, h, s, device)
        host = [x.cpu().numpy() for x in (ent, rel, qtab)]
    with spans("setup.state"):
        model, tcfg = _configs(cfg)
        model.to(device)
        load_params(model, {"params": P})
        params = params_tree(model)
        tx = setup_optimizer(tcfg.optimizer, flatten_tree(params))
        state = TrainState(params=params, opt_state=tx.init(flatten_tree(params)), step=0,
                           generator=torch.Generator(device=device).manual_seed(draw_seed(seed)))
        tables = make_tables(host[0], host[1], device=device)
        bucket = fixed_bucket_for(samples, batch)
        pin = device.type == "cuda"

        def epochs():
            for epoch in itertools.count():
                yield from iter_stacked_batches(samples, num_shards=1, per_shard_batch=batch, entity_emb=host[0],
                                                relation_emb=host[1], question_emb=host[2], bucket=bucket,
                                                seed=epoch, id_feed=True, pin=pin)

        step_fn = make_train_step(model, tx, tcfg, tables=tables)
    st = dict(cell=cell, seed=seed, device=device, qs=qs, tables=(ent, rel, qtab), P=P, model=model,
              state=state, step_fn=step_fn, feed=prefetch(epochs()), bucket_edges=bucket.edges, n=n, batch=batch)
    losses = []
    with spans("setup.first_steps"):
        for i in range(int(tr["first_steps"])):
            b = next(st["feed"])
            st["state"], metrics = step_fn(st["state"], b)
            losses.append(float(metrics["loss"]))
            if i == 0:
                b1 = float(cfg["train"]["optimizer"]["b1"])
                st["first_grad"] = {p[len("mu/params/"):]: v.detach().clone() / (1.0 - b1)
                                    for p, v in st["state"].opt_state.items() if p.startswith("mu/")}
        before, after = ref.flat(P), flatten_tree(st["state"].params)
        st["change"] = {p[len("params/"):]: (v.detach() - before[p[len("params/"):]]).clone()
                        for p, v in after.items()}
        st["losses"] = losses
    return st


def window(st: dict, seconds: float, spans) -> dict:
    graphs = edges = nodes = steps = 0
    t0 = time.perf_counter()
    while True:
        with spans("feed"):
            b = next(st["feed"])
        with spans("step"):
            st["state"], _ = st["step_fn"](st["state"], b)
        gb = b.graph
        graphs += int(gb.graph_mask.sum())
        edges += int(gb.edge_mask.sum())
        nodes += int(gb.node_mask.sum())
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if st["device"].type == "cuda":
        with spans("sync"):
            torch.cuda.synchronize(st["device"])
    window_s = time.perf_counter() - t0
    counters = dict(steps=steps, graphs=graphs, real_edges=edges, real_nodes=nodes)
    return dict(metrics=dict(train_graphs_per_s=graphs / window_s), attempted=steps, failed=0,
                window_s=window_s, counters=counters)


def finish(st: dict) -> None:
    for key in ("model", "state", "step_fn", "feed"):
        st.pop(key, None)
    common.free(st["device"])


def steps_samples(st: dict) -> list[list[int]]:
    """The questions of the first steps, in the feeder's documented order:
    epoch 0 shuffled by ``numpy.random.default_rng(0)``, cut into batches."""
    order = np.arange(st["n"])
    np.random.default_rng(0).shuffle(order)
    b = st["batch"]
    return [list(order[i * b:(i + 1) * b]) for i in range(int(st["cell"]["traffic"]["first_steps"]))]


def readings(st: dict, control: bool = False, fault: str | None = None) -> dict[str, float]:
    """``loss_gap`` (the worst step's |loss - reference| over |reference|),
    ``grad_gap`` (the first gradient) and ``change_gap`` (the parameters'
    change over the first steps), the two by the worst leaf
    (``compare.worst_leaf_gap``; the change leaves out leaves whose
    reference gradient is under a thousandth of the median leaf's).  With
    ``control`` the program's side is the reference in the precision below;
    ``fault="half_batch"`` puts the reference there with half of each batch
    left out."""
    cfg = st["cell"]["config"]
    run = lambda prec, half=False: ref_train.run(  # noqa: E731
        cfg, st["P"], st["qs"], st["tables"], steps_samples(st), prec, draw_seed(st["seed"]),
        st["bucket_edges"], half=half)
    with ref.exact_f32():
        want = run(ref.Prec("bfloat16"))
        if control or fault:
            got = run(ref.Prec("float8_e4m3fn") if control else ref.Prec("bfloat16"), half=fault == "half_batch")
        else:
            got = dict(losses=st["losses"], first_grad=st["first_grad"], change=st["change"])
    return gaps(got, want)


def gaps(got: dict, want: dict) -> dict[str, float]:
    """``readings``' numbers of first steps ``got`` against the reference's ``want``."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
    norms = {p: float(v.norm()) for p, v in want["first_grad"].items()}
    med = float(np.median(list(norms.values())))
    moving = {p for p, v in norms.items() if v >= 1e-3 * med}
    return dict(loss_gap=float(loss_gap),
                grad_gap=compare.worst_leaf_gap(got["first_grad"], want["first_grad"])[0],
                change_gap=compare.worst_leaf_gap(got["change"], want["change"], moving)[0])

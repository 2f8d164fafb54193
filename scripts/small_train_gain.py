#!/usr/bin/env python3
"""The small synthetic training setting through the ``train_retriever`` CLI
of either package, on the CPU: validation ``edge/recall@5`` of the untrained
parameters (same seed, same batches) and after training, and the gain.

    JAX_PLATFORMS=cpu python scripts/small_train_gain.py jax
    python scripts/small_train_gain.py torch [cpu|cuda]

The overrides are ``evi_rag_tpu_torch.testing.SMALL_TRAIN_OVERRIDES``; both
packages must clear ``SMALL_TRAIN_MIN_GAIN``.  Prints one JSON line.
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from evi_rag_tpu_torch.testing import SMALL_TRAIN_MIN_GAIN, SMALL_TRAIN_OVERRIDES  # noqa: E402


def jax_gain(out: pathlib.Path) -> dict:
    from evi_rag_tpu import cli
    from evi_rag_tpu.data.feeder import collate_retriever, fixed_bucket_for
    from evi_rag_tpu.models.batches import make_tables
    from evi_rag_tpu.train.retriever_trainer import create_train_state, evaluate, make_eval_step
    from evi_rag_tpu.utils.config import load_config

    overrides = [*SMALL_TRAIN_OVERRIDES, f"retriever.train.ckpt_dir={out / 'ckpt'}", f"paths.log_dir={out / 'logs'}"]
    if cli.main(["train_retriever", "--configs-dir", str(ROOT / "configs"), *overrides]) != 0:
        raise RuntimeError("train_retriever failed")
    metrics = json.loads(sorted((out / "logs").glob("**/metrics.json"))[-1].read_text())
    cfg = load_config(str(ROOT / "configs"), "train_retriever", overrides)
    train, ent, rel, q_train = cli._load_split(cfg, "train")
    val, _, _, q_val = cli._load_split(cfg, "validation")
    per = int(cfg["retriever"]["train"]["per_shard_batch"])
    bucket = fixed_bucket_for(list(train) + list(val), per)
    tables = make_tables(ent, rel)
    model = cli._retriever_model(cfg, inferred_dim=ent.shape[1])
    tcfg = cli._retriever_train_cfg(cfg)
    first = collate_retriever(train[:per], entity_emb=ent, relation_emb=rel, question_emb=q_train,
                              bucket=bucket, id_feed=True)
    state, _ = create_train_state(model, first, tcfg, seed=int(cfg["retriever"]["train"].get("seed", 0)),
                                  tables=tables)
    batches = (collate_retriever(val[i : i + per], entity_emb=ent, relation_emb=rel, question_emb=q_val,
                                 bucket=bucket, id_feed=True) for i in range(0, len(val), per))
    before = evaluate(state.params, make_eval_step(model, tcfg, tables=tables), batches)["edge/recall@5"]
    after = metrics["edge/recall@5"]
    return {"before": before, "after": after, "gain": after - before}


def main() -> int:
    package = sys.argv[1] if len(sys.argv) > 1 else "jax"
    with tempfile.TemporaryDirectory() as tmp:
        if package == "jax":
            res = jax_gain(pathlib.Path(tmp))
        else:
            from evi_rag_tpu_torch.testing import small_train_gain

            device = sys.argv[2] if len(sys.argv) > 2 else "cpu"
            res = small_train_gain(ROOT / "configs", tmp, device)
            res = {k: res[k] for k in ("before", "after", "gain")}
    res["package"], res["min_gain"] = package, SMALL_TRAIN_MIN_GAIN
    print(json.dumps(res))
    return 0 if res["gain"] > SMALL_TRAIN_MIN_GAIN else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env bash
# End-to-end 6-step pipeline driver of the PyTorch port (the port's copy of
# scripts/run_full_pipeline.sh): build -> train_retriever(sub) ->
# eval_retriever(full+sub, all splits, g_agent) -> train_gflownet(sub) ->
# eval_gflownet -> reasoner(oracle).
#
# Usage: evi_rag_tpu_torch/scripts/run_full_pipeline.sh <dataset> [artifacts_dir] [overrides...]
# The overrides go to every stage: the stages run on the GPU unless
# `device=cpu` is among them.  `build` reads raw parquet (needs pyarrow).
set -euo pipefail

DATASET="${1:?usage: run_full_pipeline.sh <dataset> [artifacts_dir] [overrides...]}"
ART="${2:-artifacts/$DATASET}"
shift $(( $# < 2 ? $# : 2 ))
CLI="python -m evi_rag_tpu_torch.cli"

echo "== [1/6] build =="
$CLI build build.dataset="$DATASET" build.raw_root="data/raw/$DATASET" \
  build.out_dir="data/normalized/$DATASET" "$@"

echo "== [2/6] train_retriever (sub scope) =="
$CLI train_retriever dataset="$DATASET-sub" \
  retriever.train.ckpt_dir="$ART/ckpt/retriever" "$@"

RETRIEVER_CKPT="$ART/ckpt/retriever/best"

echo "== [3/6] eval_retriever (full + sub, all splits, g_agent) =="
for variant in "$DATASET" "$DATASET-sub"; do
  $CLI eval_retriever dataset="$variant" retriever.ckpt="$RETRIEVER_CKPT" \
    "eval.splits=[train, validation, test]" eval.artifacts_dir="$ART/$variant" "$@"
done

echo "== [4/6] train_gflownet (sub scope) =="
$CLI train_gflownet dataset="$DATASET-sub" retriever.ckpt="$RETRIEVER_CKPT" \
  gflownet.g_agent_dir="$ART/$DATASET-sub/g_agent" \
  gflownet.ckpt_dir="$ART/ckpt/gflownet" "$@"

GFLOWNET_CKPT="$ART/ckpt/gflownet/best"

echo "== [5/6] eval_gflownet =="
$CLI eval_gflownet dataset="$DATASET-sub" gflownet.ckpt="$GFLOWNET_CKPT" \
  gflownet.g_agent_dir="$ART/$DATASET-sub/g_agent" \
  eval.artifacts_dir="$ART/$DATASET-sub" "$@"

echo "== [6/6] reasoner (oracle upper bound) =="
$CLI reasoner dataset="$DATASET-sub" \
  gflownet.g_agent_dir="$ART/$DATASET-sub/g_agent" \
  eval.artifacts_dir="$ART/$DATASET-sub" "$@"

echo "pipeline complete: artifacts under $ART"

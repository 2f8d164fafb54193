#!/usr/bin/env bash
# Hide-and-seek mask ablation sweep of the PyTorch port (the port's copy of
# scripts/run_retriever_mask_ablation.sh): trains the retriever across a grid
# of near/far demotion probabilities and biases.
#
# Usage: run_retriever_mask_ablation.sh [dataset] [extra overrides...]
# (on the GPU unless `device=cpu` is among the overrides)
# Grid via env: ABLATION_P_NEAR="0.0 0.3 0.6"  ABLATION_BIAS_NEAR="-2.0 -5.0"
set -euo pipefail

DATASET="${1:-synthetic}"
shift || true
CLI="python -m evi_rag_tpu_torch.cli"
P_GRID=(${ABLATION_P_NEAR:-0.0 0.3 0.6})
B_GRID=(${ABLATION_BIAS_NEAR:--2.0 -5.0})

for p_near in "${P_GRID[@]}"; do
  for bias in "${B_GRID[@]}"; do
    echo "== ablation p_near=$p_near bias_near=$bias =="
    $CLI train_retriever dataset="$DATASET" \
      retriever.model.hide_seek.enabled=true \
      retriever.model.hide_seek.p_near="$p_near" \
      retriever.model.hide_seek.bias_near="$bias" \
      "$@"
  done
done

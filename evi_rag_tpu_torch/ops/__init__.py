"""Device-side building blocks of the port: segment ops, graph batches, the
scorers and their kernels, kNN."""

from evi_rag_tpu_torch.ops.knn import knn_topk, knn_topk_sharded

__all__ = ["knn_topk", "knn_topk_sharded"]

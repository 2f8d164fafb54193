"""Padded multi-graph batches with a reserved padding graph.

Counterpart of ``evi_rag_tpu/ops/graph.py``.  A batch has ``G`` graph slots,
``N`` node slots and ``E`` edge slots; real graphs are packed contiguously
(``node_ptr`` / ``edge_ptr``), and the **last graph slot is the padding
graph**: it owns every padding node and padding edge, and padding edges
self-loop on the first padding node.  So every per-graph segment reduction
is right without extra masking, and ``graph_mask`` keeps the padding graph
out of every mean.

``pad_graphs`` builds the arrays on the host with numpy (bit for bit the JAX
package's) and wraps them as CPU tensors; ``batch_to`` moves any batch of
this module or ``models/batches.py`` to a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch


def map_tensors(obj: Any, fn) -> Any:
    """Apply ``fn`` to every tensor of a (nested) batch dataclass or dict."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(getattr(obj, f.name), fn) for f in dataclasses.fields(obj)
        })
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    return obj


def batch_to(batch: Any, device: torch.device, *, non_blocking: bool = True) -> Any:
    """The batch on ``device``; from pinned host memory the copies do not
    block the host."""
    return map_tensors(batch, lambda t: t.to(device, non_blocking=non_blocking))


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    """Index structure of a padded flat multi-graph batch (a stacked batch
    has a leading shard axis on every field)."""

    edge_index: torch.Tensor  # [2, E] int32, global node ids (head, tail)
    edge_batch: torch.Tensor  # [E] int32 in [0, G)
    node_batch: torch.Tensor  # [N] int32 in [0, G)
    node_ptr: torch.Tensor    # [G+1] int32
    edge_ptr: torch.Tensor    # [G+1] int32
    node_mask: torch.Tensor   # [N] bool
    edge_mask: torch.Tensor   # [E] bool
    graph_mask: torch.Tensor  # [G] bool (False for the padding graph + unused slots)

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[-1]

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[-1]

    @property
    def heads(self) -> torch.Tensor:
        return self.edge_index[..., 0, :]

    @property
    def tails(self) -> torch.Tensor:
        return self.edge_index[..., 1, :]


def pad_graph_arrays(
    *,
    edge_index: Sequence[np.ndarray],
    num_nodes: Sequence[int],
    bucket_graphs: int,
    bucket_nodes: int,
    bucket_edges: int,
) -> dict[str, np.ndarray]:
    """The numpy arrays of ``pad_graphs``."""
    n_real = len(num_nodes)
    if len(edge_index) != n_real:
        raise ValueError("edge_index and num_nodes length mismatch")
    if n_real > bucket_graphs - 1:
        raise ValueError(
            f"bucket has {bucket_graphs} graph slots (1 reserved for padding); got {n_real} graphs"
        )
    total_nodes = int(sum(num_nodes))
    total_edges = int(sum(e.shape[1] for e in edge_index))
    if total_nodes > bucket_nodes:
        raise ValueError(f"total nodes {total_nodes} exceed bucket_nodes {bucket_nodes}")
    if total_edges > bucket_edges:
        raise ValueError(f"total edges {total_edges} exceed bucket_edges {bucket_edges}")

    G, N, E = bucket_graphs, bucket_nodes, bucket_edges
    pad_graph = G - 1
    node_ptr = np.zeros(G + 1, dtype=np.int32)
    edge_ptr = np.zeros(G + 1, dtype=np.int32)
    node_batch = np.full(N, pad_graph, dtype=np.int32)
    edge_batch = np.full(E, pad_graph, dtype=np.int32)
    ei = np.zeros((2, E), dtype=np.int32)

    n_off = e_off = 0
    for g in range(n_real):
        nn, ne = int(num_nodes[g]), int(edge_index[g].shape[1])
        node_ptr[g + 1] = n_off + nn
        edge_ptr[g + 1] = e_off + ne
        node_batch[n_off : n_off + nn] = g
        edge_batch[e_off : e_off + ne] = g
        if ne:
            e = np.asarray(edge_index[g], dtype=np.int32)
            if e.size and (e.min() < 0 or e.max() >= nn):
                raise ValueError(f"graph {g}: edge_index out of range [0, {nn})")
            ei[:, e_off : e_off + ne] = e + n_off
        n_off += nn
        e_off += ne
    # Empty slots between the last real graph and the padding graph.
    for g in range(n_real, G):
        node_ptr[g + 1] = n_off if g < pad_graph else N
        edge_ptr[g + 1] = e_off if g < pad_graph else E
    node_ptr[G] = N
    edge_ptr[G] = E
    # Padding edges self-loop on the first padding node (or node 0 if none).
    pad_node = min(n_off, N - 1) if N > n_off else max(N - 1, 0)
    ei[:, e_off:] = pad_node

    node_mask = np.zeros(N, dtype=bool)
    node_mask[:n_off] = True
    edge_mask = np.zeros(E, dtype=bool)
    edge_mask[:e_off] = True
    graph_mask = np.zeros(G, dtype=bool)
    graph_mask[:n_real] = True
    return dict(edge_index=ei, edge_batch=edge_batch, node_batch=node_batch, node_ptr=node_ptr,
                edge_ptr=edge_ptr, node_mask=node_mask, edge_mask=edge_mask, graph_mask=graph_mask)


def pad_graphs(
    *,
    edge_index: Sequence[np.ndarray],
    num_nodes: Sequence[int],
    bucket_graphs: int,
    bucket_nodes: int,
    bucket_edges: int,
) -> GraphBatch:
    """Pack a list of graphs into one padded ``GraphBatch`` of CPU tensors.

    ``edge_index[i]`` is ``[2, E_i]`` with graph-local node ids.  Requires
    ``len(graphs) <= bucket_graphs - 1`` (the last slot is the padding graph).
    """
    arrays = pad_graph_arrays(edge_index=edge_index, num_nodes=num_nodes, bucket_graphs=bucket_graphs,
                              bucket_nodes=bucket_nodes, bucket_edges=bucket_edges)
    return GraphBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def scatter_node_values(
    values: Sequence[np.ndarray],
    bucket_nodes: int,
    *,
    fill: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """Concatenate per-graph node arrays and pad the node axis to the bucket."""
    cat = np.concatenate([np.asarray(v) for v in values], axis=0) if values else np.zeros((0,), dtype=dtype)
    out = np.full((bucket_nodes,) + cat.shape[1:], fill, dtype=dtype)
    out[: cat.shape[0]] = cat
    return out

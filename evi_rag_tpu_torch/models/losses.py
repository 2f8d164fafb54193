"""Retriever training objective: multi-positive grouped InfoNCE (+ optional BCE).

Counterpart of ``evi_rag_tpu/models/losses.py``.  Per graph g::

    L_g = logsumexp_{e in g}(s_e) - logsumexp_{e in g, y_e=1}(s_e)

with ``s = logits / T + log(edge_weight)``; graphs without both a positive
and a negative edge are left out of the mean, and a batch with no such graph
gives a zero loss.  The padding graph takes the padding edges; ``graph_mask``
gates the mean.
"""

from __future__ import annotations

import dataclasses

import torch

from evi_rag_tpu_torch.ops.segment import segment_logsumexp, segment_sum

POS_LABEL_THRESHOLD = 0.5
_MIN_EDGE_WEIGHT = 1e-6


@dataclasses.dataclass(frozen=True)
class LossOutput:
    loss: torch.Tensor
    components: dict[str, torch.Tensor]
    metrics: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RetrieverLossConfig:
    infonce_temperature: float = 1.0
    infonce_weight: float = 1.0
    bce_weight: float = 0.0
    edge_weight_near: float = 1.0
    edge_weight_bridge: float = 1.0

    def __post_init__(self) -> None:
        if self.infonce_temperature <= 0:
            raise ValueError("infonce_temperature must be positive")
        if self.infonce_weight < 0 or self.bce_weight < 0:
            raise ValueError("loss weights must be non-negative")
        if self.infonce_weight == 0 and self.bce_weight == 0:
            raise ValueError("at least one non-zero loss weight required")
        if self.edge_weight_near <= 0 or self.edge_weight_bridge <= 0:
            raise ValueError("edge weights must be positive")

    @property
    def requires_edge_is_near(self) -> bool:
        return self.edge_weight_near != 1.0 or self.edge_weight_bridge != 1.0


def retriever_loss(
    logits: torch.Tensor,       # [E]
    labels: torch.Tensor,       # [E] float
    edge_batch: torch.Tensor,   # [E] int
    *,
    num_graphs: int,
    graph_mask: torch.Tensor,   # [G] bool
    edge_mask: torch.Tensor,    # [E] bool
    config: RetrieverLossConfig,
    edge_is_near: torch.Tensor | None = None,
) -> LossOutput:
    labels = labels.float()
    edge_mask = edge_mask.bool()
    pos_mask = (labels > POS_LABEL_THRESHOLD) & edge_mask
    neg_mask = (labels <= POS_LABEL_THRESHOLD) & edge_mask
    logits = logits.float()

    scores = logits / config.infonce_temperature
    w = None
    if config.requires_edge_is_near:
        if edge_is_near is None:
            raise ValueError("edge_is_near required when edge weights are enabled")
        w = torch.where(edge_is_near, torch.tensor(config.edge_weight_near, device=logits.device),
                        torch.tensor(config.edge_weight_bridge, device=logits.device))
        scores = scores + torch.log(w.clamp(min=_MIN_EDGE_WEIGHT))

    lse_all = segment_logsumexp(scores, edge_batch, num_graphs, mask=edge_mask)
    lse_pos = segment_logsumexp(scores, edge_batch, num_graphs, mask=pos_mask)
    pos_counts = segment_sum(pos_mask.float(), edge_batch, num_graphs)
    neg_counts = segment_sum(neg_mask.float(), edge_batch, num_graphs)
    valid = (pos_counts > 0) & (neg_counts > 0) & graph_mask.bool()

    zero = torch.zeros((), device=logits.device)
    per_graph = torch.where(valid, lse_all - lse_pos, zero)
    n_valid = valid.float().sum()
    infonce = per_graph.sum() / n_valid.clamp(min=1.0)
    infonce = torch.where(n_valid > 0, infonce, zero)

    bce = zero
    if config.bce_weight > 0:
        per_edge = _bce_with_logits(logits, labels)
        if w is not None:
            per_edge = per_edge * w
            denom = segment_sum(w, edge_batch, num_graphs, mask=edge_mask)
        else:
            denom = segment_sum(edge_mask.float(), edge_batch, num_graphs)
        loss_sum = segment_sum(per_edge, edge_batch, num_graphs, mask=edge_mask)
        g_valid = (denom > 0) & graph_mask.bool()
        per_g = torch.where(g_valid, loss_sum / denom.clamp(min=_MIN_EDGE_WEIGHT), zero)
        bce = per_g.sum() / g_valid.float().sum().clamp(min=1.0)

    total = config.infonce_weight * infonce + config.bce_weight * bce

    probs = torch.sigmoid(logits)
    pos_avg = torch.where(pos_mask, probs, zero).sum() / pos_mask.sum().clamp(min=1)
    neg_avg = torch.where(neg_mask, probs, zero).sum() / neg_mask.sum().clamp(min=1)
    return LossOutput(
        loss=total,
        components={"infonce": infonce, "bce": bce},
        metrics={
            "pos_prob": pos_avg,
            "neg_prob": neg_avg,
            "separation": pos_avg - neg_avg,
            "infonce_graphs": n_valid,
            "infonce_pos_edges": pos_mask.float().sum(),
            "infonce_neg_edges": neg_mask.float().sum(),
        },
    )


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Stable elementwise binary cross-entropy with logits.  At a logit of
    exactly 0 the gradient is JAX's: ``maximum`` (not ``clamp``) splits it in
    half, as ``jnp.maximum`` does, and ``|x|`` has slope 1 there, as
    ``jnp.abs`` has."""
    abs_logits = torch.where(logits >= 0, logits, -logits)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + torch.log1p(torch.exp(-abs_logits)))

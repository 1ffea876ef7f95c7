"""Prediction layer: weighted K-NN voting + Matthews correlation coefficient
(counterpart of ``repro.core.predict``), in float32 as the JAX package."""
from __future__ import annotations

import torch


def weighted_vote(
    labels: torch.Tensor, knn_idx: torch.Tensor, knn_dist: torch.Tensor
) -> torch.Tensor:
    """Distance-weighted binary vote over the last axis: labels (n,) {0,1},
    knn (..., K) -> (...,) int32 {0,1}."""
    valid = knn_idx >= 0
    w = torch.where(valid, 1.0 / (knn_dist + 1e-6), 0.0)
    y = labels[knn_idx.long().clamp(0, labels.shape[0] - 1)].to(torch.float32)
    score = (w * y).sum(dim=-1) / w.sum(dim=-1).clamp(min=1e-9)
    return (score >= 0.5).to(torch.int32)


def predict_batch(
    labels: torch.Tensor, knn_idx: torch.Tensor, knn_dist: torch.Tensor
) -> torch.Tensor:
    """(Q, K) neighbours -> (Q,) {0,1} predictions."""
    return weighted_vote(labels, knn_idx, knn_dist)


def confusion(pred: torch.Tensor, true: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Binary confusion counts ``(tp, tn, fp, fn)`` over {0,1} vectors."""
    pred = pred.to(torch.int32)
    true = true.to(torch.int32)
    tp = ((pred == 1) & (true == 1)).sum()
    tn = ((pred == 0) & (true == 0)).sum()
    fp = ((pred == 1) & (true == 0)).sum()
    fn = ((pred == 0) & (true == 1)).sum()
    return tp, tn, fp, fn


def mcc(pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
    """Matthews correlation coefficient in [-1, 1]."""
    tp, tn, fp, fn = (x.to(torch.float32) for x in confusion(pred, true))
    num = tp * tn - fp * fn
    den = torch.sqrt((tp + fp) * (tp + fn)) * torch.sqrt((tn + fp) * (tn + fn))
    return torch.where(den > 0, num / den, 0.0).to(torch.float32)

"""Error-feedback gradient compression for the data-parallel all-reduce.

Port of ``repro/optim/compression.py``: top-k magnitude sparsification
with a residual accumulator.  Each step a worker sends only the largest
``ratio`` fraction of each tensor's entries (the threshold is the k-th
largest ``|acc|``, and ``>=`` keeps its ties) and folds the rest into a
residual added back next step.  Gradients and residuals are dicts of
tensors keyed by parameter name; the dense masked tensor stands in for
the (value, index) pairs, whose bytes ``stats`` reports.
"""
from __future__ import annotations

import torch


def init(params: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.named_parameters()}


def _topk_mask(x: torch.Tensor, ratio: float) -> torch.Tensor:
    k = max(int(x.numel() * ratio), 1)
    thresh = torch.topk(torch.abs(x.reshape(-1)), k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


def compress(grads: dict, residual: dict, ratio: float = 0.01):
    """Returns ``(sparse grads, new residual, stats)``."""
    sent, new_res, kept = {}, {}, None
    for name, g in grads.items():
        acc = g.to(torch.float32) + residual[name]
        mask = _topk_mask(acc, ratio)
        s = acc * mask
        sent[name] = s.to(g.dtype)
        new_res[name] = acc - s
        kept = mask.sum() if kept is None else kept + mask.sum()
    total = sum(int(g.numel()) for g in grads.values())
    stats = {
        "kept_fraction": kept / total,
        # Bytes over the DP axis if sent as (f16 value, i32 index) pairs:
        "compressed_bytes": kept * 6.0,
        "dense_bytes": float(total * 2),
    }
    return sent, new_res, stats

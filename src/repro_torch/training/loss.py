"""Chunked cross-entropy: the (tokens, vocab) logits matrix is never
materialised — a loop over token chunks computes logsumexp and the NLL of
each chunk (256k vocab x 1M tokens would otherwise need ~33 GB at bf16).
On a mesh each rank runs the same loop over its own batch rows."""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.layers import softcap


def chunked_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 2048,
                          logit_softcap: float = 0.0,
                          ignore_index: int = -100) -> torch.Tensor:
    """h: (B, T, d) final hidden (post norm); w: (d, V); labels: (B, T).
    Returns the mean NLL over the positions whose label is not
    `ignore_index` (fp32, a () tensor). Each chunk's logits are the
    product in h's dtype widened to fp32 (then soft-capped), as the
    reference's; the last chunk is shorter where the tokens do not fill
    it, which is the reference's padded tail without the padding."""
    if shd.is_dtensor(h):
        return _cross_entropy_mesh(h, w, labels, chunk, logit_softcap,
                                   ignore_index)
    total, count = _nll_sums(h, w, labels, chunk, logit_softcap, ignore_index)
    return total / torch.clamp(count, min=1.0)


def _nll_sums(h, w, labels, chunk, logit_softcap, ignore_index):
    """(summed NLL, number of counted positions), both () fp32."""
    B, T, d = h.shape
    x = h.reshape(B * T, d)
    y = labels.reshape(B * T)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, x.shape[0], chunk):
        xb, yb = x[c0:c0 + chunk], y[c0:c0 + chunk]
        logits = softcap((xb @ w).float(), logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1,
                              torch.clamp(yb, min=0).long()[:, None])[:, 0]
        mask = (yb != ignore_index).float()
        total = total + torch.sum((lse - picked) * mask)
        count = count + torch.sum(mask)
    return total, count


def _cross_entropy_mesh(h, w, labels, chunk, logit_softcap, ignore_index):
    """On a mesh: the whole head (gathered over every axis) against each
    rank's batch rows; the ranks' sums add up over the batch axes. A plain
    () tensor, like the loss without a mesh."""
    w = shd.constrain(w, (None, None))
    total, count = shd.region(
        lambda h_, w_, y_: tuple(t.reshape(1) for t in _nll_sums(
            h_, w_, y_, chunk, logit_softcap, ignore_index)),
        h, w, shd.batch_like(labels, h), like=h, out=shd.Out((shd.BATCH,)))
    return (total.sum() / torch.clamp(count.sum(), min=1.0)).full_tensor()

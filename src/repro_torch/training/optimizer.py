"""AdamW as plain functions over the param tree (nested dicts and lists of
tensors), the reference's update: fp32 moments shaped like the params, a
global-norm gradient clip, bias correction, decoupled weight decay, and
params updated through fp32 and rounded back to their own dtype.
(`torch.optim.AdamW` updates in another order and dtype, so it is not
used.) Leaves pair up in `repro_torch.tree`'s order, the reference's."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int64 on the params' device
    m: Any                 # fp32, shaped like the params
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero moments laid out like the params (DTensors on a mesh)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.long, device=dev),
                      tree_map(zeros, params), tree_map(zeros, params))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 grad_clip: float = 1.0) -> Tuple[Any, AdamWState]:
    """One step. Returns (new params, new state); the inputs are left as
    they were. Leaf by leaf, so the fp32 temporaries are one leaf's."""
    step = state.step + 1
    g_leaves = tree_leaves(grads)
    scale = None
    if grad_clip > 0:     # the clip scales each gradient in its own dtype
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in g_leaves))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    m0 = tree_leaves(state.m)[0]
    b1c = shd.replicate_like(1.0 - b1 ** step.float(), m0)
    b2c = shd.replicate_like(1.0 - b2 ** step.float(), m0)
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(g_leaves, tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * torch.square(g32)
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + eps)
        if weight_decay > 0:
            delta = delta + weight_decay * p.float()
        new_p.append((p.float() - lr * delta).to(p.dtype))
        new_m.append(m2)
        new_v.append(v2)
    return (tree_unflatten(params, new_p),
            AdamWState(step, tree_unflatten(params, new_m),
                       tree_unflatten(params, new_v)))

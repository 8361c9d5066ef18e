"""Step builders: train_step / prefill_step / serve_step for any config the
port runs, and the initial train state.

A train step is eager PyTorch: the loss's backward pass gives the
gradients (`torch.autograd.grad` over the param tree's leaves), an
optional `grad_transform` (int8 compression with error feedback, see
`distributed.compression`) edits them, and `adamw_update` makes new
params and a new optimizer state. Randomness (the init) comes from an
explicit `torch.Generator`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import Model
from repro_torch.training.loss import chunked_cross_entropy
from repro_torch.training.optimizer import (AdamWState, adamw_init,
                                            adamw_update)
from repro_torch.tree import tree_leaves, tree_unflatten


def make_loss_fn(model: Model, remat: bool = True, ce_chunk: int = 2048):
    """loss_fn(params, batch) -> () fp32 mean NLL. batch: {"tokens",
    "labels"} (B, T), {"embeds" (B, T, d), "labels"} for an arch that
    takes input embeddings, or an encoder-decoder's {"frames" (B, S, d),
    "tokens", "labels"}. `remat=True` recomputes each layer in the
    backward pass (`torch.utils.checkpoint`)."""
    cfg = model.cfg

    def loss_fn(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if cfg.uses_input_embeds and "embeds" in batch:
            h = model.forward(params, embeds=batch["embeds"], remat=remat)
        elif cfg.is_encoder_decoder:
            enc_out = model.encode(params, batch["frames"])
            h = model.forward(params, batch["tokens"], enc_out=enc_out,
                              remat=remat)
        else:
            h = model.forward(params, batch["tokens"], remat=remat)
        hf = model.final_hidden(params, h)
        return chunked_cross_entropy(
            hf, model.lm_head_weight(params), batch["labels"],
            chunk=ce_chunk, logit_softcap=cfg.final_logit_softcap)

    return loss_fn


def value_and_grad(loss_fn: Callable) -> Callable:
    """(params, batch) -> (loss, grads): grads a tree like params (the
    params are not modified and need not require grad)."""

    def vg(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        tracked = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss = loss_fn(tracked, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else _like_param(g, p)
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    return vg


def _like_param(g, p):
    """A gradient laid out as its param (on a mesh the backward pass may
    leave it a partial sum over the batch axes: this all-reduces it)."""
    if shd.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, *, lr: float = 3e-4, remat: bool = True,
                    ce_chunk: int = 2048,
                    grad_transform: Optional[Callable] = None):
    """train_step(params, opt_state, batch) -> (params, opt, {"loss"}).

    `grad_transform` (optional) is applied to the gradient tree before the
    optimizer — the hook of gradient compression."""
    vg = value_and_grad(make_loss_fn(model, remat, ce_chunk))

    def train_step(params, opt_state: AdamWState, batch):
        loss, grads = vg(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, {"loss": loss}

    return train_step


def make_prefill_step(model: Model, max_seq: int):
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(params, batch):
        if cfg.uses_input_embeds and "embeds" in batch:
            return model.prefill(params, embeds=batch["embeds"],
                                 max_seq=max_seq)
        if cfg.is_encoder_decoder:
            return model.prefill(params, batch["tokens"], max_seq=max_seq,
                                 enc_out=model.encode(params,
                                                      batch["frames"]))
        return model.prefill(params, batch["tokens"], max_seq=max_seq)

    return prefill_step


def make_serve_step(model: Model):
    """One decode token against an existing cache."""

    @torch.no_grad()
    def serve_step(params, token, cache):
        return model.decode_step(params, token, cache)

    return serve_step


def init_train_state(model: Model, generator: Optional[torch.Generator] = None,
                     device="cuda") -> Tuple[Any, AdamWState]:
    params = model.init(generator, device=device)
    return params, adamw_init(params)

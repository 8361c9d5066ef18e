"""Abstract input builders for every (arch x shape) dry-run cell.

No data: parameters, optimizer state, batches and KV caches are fake
tensors (`torch._subclasses.fake_tensor.FakeTensorMode`, which the caller
holds open) laid out on the mesh as DTensors, the counterpart of the
reference's `ShapeDtypeStruct`s with their `NamedSharding`s. The params are
initialised on the meta device (shapes and dtypes only) and become fake
tensors of the same shapes. The fake device is the CPU, so a kernel's
wrapper takes its plain version there.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ShapeCell
from repro_torch.distributed.sharding import (Sharding, batch_sharding,
                                              distribute_params, placements,
                                              replicated)
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import AdamWState, adamw_init
from repro_torch.tree import tree_map


def _fake(t: torch.Tensor) -> torch.Tensor:
    """A (fake, under the caller's mode) CPU tensor shaped like `t`."""
    return torch.empty(t.shape, dtype=t.dtype)


def _put(t: torch.Tensor, sharding: Sharding):
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def abstract_params(model: Model, mesh, fsdp: bool):
    return distribute_params(tree_map(_fake, model.init(device="meta")),
                             mesh, fsdp=fsdp)


def abstract_opt_state(params_abs, mesh, fsdp: bool) -> AdamWState:
    """fp32 moments laid out as the params (their shapes are the params',
    so their shardings are too)."""
    return adamw_init(params_abs)


def _cache_sharding(mesh, shape: Tuple[int, ...], batch: int) -> Sharding:
    """Cache sharding: dim0=batch -> data axes; a feature dim -> model.

    NEVER shard the sequence axis (dim1 of rank>=3 caches): decode inserts
    at a position along it, which a partitioner can only shard by
    replicating (the reference measured an 80 GiB/device blow-up on
    decode_32k). Preference order for the model axis: heads (dim2), then
    head_dim/feature (dim3+), largest divisible first.
    """
    rank = len(shape)
    spec: list = [None] * rank
    # locate the batch dim: stacked caches are (U, B, ...), the rest (B, ...)
    b_idx = None
    for i in range(min(2, rank)):
        if shape[i] == batch:
            b_idx = i
            break
    names = tuple(mesh.mesh_dim_names)
    daxes = tuple(a for a in ("pod", "data") if a in names)
    if b_idx is not None and daxes:
        n = 1
        for a in daxes:
            n *= mesh.size(names.index(a))
        if batch % n == 0:
            spec[b_idx] = daxes
    if "model" in names:
        start = (b_idx + 1) if b_idx is not None else 1
        if rank - start >= 2:
            start += 1               # skip the seq axis
        msize = mesh.size(names.index("model"))
        for i in range(start, rank):
            if shape[i] % msize == 0 and shape[i] >= msize:
                spec[i] = "model"
                break
    return Sharding(mesh, tuple(spec), placements(spec, mesh))


def abstract_cache(model: Model, mesh, batch: int, max_seq: int,
                   src_len: int = 0):
    cache = model.init_cache(batch, max_seq, device="meta", src_len=src_len)
    return tree_map(
        lambda t: _put(_fake(t), _cache_sharding(mesh, tuple(t.shape), batch)
                       if t.dim() >= 2 else replicated(mesh, t.dim())),
        cache)


def abstract_batch(cfg: ModelConfig, cell: ShapeCell, mesh,
                   kind: str) -> Dict[str, Any]:
    """Training / prefill batch for one shape cell."""
    B, S = cell.global_batch, cell.seq_len

    def bs(shape, dt):
        return _put(torch.empty(shape, dtype=dt),
                    batch_sharding(mesh, len(shape), 0, B))

    batch: Dict[str, Any] = {}
    if cfg.is_encoder_decoder:
        # enc-dec token budget: frames + decoder tokens == S per sample
        enc_len = min(cfg.max_source_positions * 2, max(S // 2, 8))
        dec_len = max(S - enc_len, 8) if kind == "train" else min(S, 448)
        if kind == "prefill":
            enc_len, dec_len = S, 448   # stress encoder at the cell seq_len
        batch["frames"] = bs((B, enc_len, cfg.d_model), torch.bfloat16)
        batch["tokens"] = bs((B, dec_len), torch.long)
        if kind == "train":
            batch["labels"] = bs((B, dec_len), torch.long)
    elif cfg.uses_input_embeds:
        batch["embeds"] = bs((B, S, cfg.d_model), torch.bfloat16)
        if kind == "train":
            batch["labels"] = bs((B, S), torch.long)
    else:
        batch["tokens"] = bs((B, S), torch.long)
        if kind == "train":
            batch["labels"] = bs((B, S), torch.long)
    return batch


def decode_inputs(cfg: ModelConfig, cell: ShapeCell, mesh, model: Model):
    """(token, cache) abstract inputs for serve_step at this cell."""
    B, S = cell.global_batch, cell.seq_len
    token = _put(torch.empty((B,), dtype=torch.long),
                 batch_sharding(mesh, 1, 0, B))
    src = cfg.max_source_positions if cfg.is_encoder_decoder else 0
    return token, abstract_cache(model, mesh, B, S, src_len=src)

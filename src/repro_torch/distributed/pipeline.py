"""Pipeline parallelism over the pod axis (GPipe-style: a stage loop on
each rank's local shards, activations passed on with a collective permute).

The default multi-pod configuration runs the pod axis as pure data
parallel, but for models whose layer stack exceeds one pod's memory the
pod axis can be stages instead: each pod holds `num_units / n_stages` of
the layers, microbatches stream through with a ring permute, and the
bubble fraction is (S-1)/(M+S-1).

`pipeline_stages` is the stage loop; `make_pipelined_forward` runs it as a
region of the mesh (stage params sharded by stage over ``pod``, the
microbatches' batch over ``data``). The permute is
`torch.distributed._functional_collectives.permute_tensor` on the stage
axis, so it can be traced and counted like the other collectives
(`launch.hlo` records it as a collective permute).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed._functional_collectives as funcol

from repro_torch.distributed import sharding as shd
from repro_torch.launch.hlo import as_kind


def pipeline_stages(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                    n_stages: int, n_microbatches: int,
                    axis_name: str = "pod", mesh=None):
    """Returns pipelined(stage_params, x_microbatches) over local shards.

    stage_fn(params, x) is ONE stage's compute; each rank along
    `axis_name` of `mesh` (default: the active mesh) holds its stage's
    params, and microbatches rotate through a ring permute each tick.
    x_microbatches: (M, mb, ...) stacked microbatches (stage 0's input).
    The last stage returns the (M, mb, ...) outputs; the others zeros.
    """
    S, M = n_stages, n_microbatches
    assert M >= 1

    def pipelined(stage_params, x_mb):
        m = shd.get_mesh() if mesh is None else mesh
        stage = m.get_local_rank(axis_name)
        mb_shape = x_mb.shape[1:]
        buf = torch.zeros(mb_shape, dtype=x_mb.dtype, device=x_mb.device)
        outputs = torch.zeros((M,) + mb_shape, dtype=x_mb.dtype,
                              device=x_mb.device)
        ring = [(i + 1) % S for i in range(S)]     # stage i -> i + 1
        for t in range(M + S - 1):
            # stage 0 injects microbatch t (the last one past the end);
            # the others take what the previous stage passed on
            x_in = x_mb[min(t, M - 1)] if stage == 0 else buf
            y = stage_fn(stage_params, x_in)
            with as_kind("collective-permute"):   # flat: it splits dim 0
                buf = funcol.wait_tensor(funcol.permute_tensor(
                    y.reshape(-1), ring, m.get_group(axis_name))).reshape(
                        mb_shape)
            # the last stage's output at tick t is microbatch t - (S - 1)
            mb_idx = t - (S - 1)
            if stage == S - 1 and mb_idx >= 0:
                outputs[mb_idx] = y
        return outputs

    return pipelined


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def make_pipelined_forward(mesh, stage_fn, n_stages: int,
                           n_microbatches: int):
    """fwd(stage_params, x_mb) on `mesh`: stage params (DTensors) sharded
    by stage over ``pod`` (each rank's local block is its stage's, with a
    leading dim of 1), x_mb (M, mb, ...) with its batch over ``data``.
    The outputs are summed over ``pod`` (only the last stage's are not
    zero), so every stage returns them."""
    pipelined = pipeline_stages(stage_fn, n_stages, n_microbatches, "pod",
                                mesh)

    def fwd(stage_params, x_mb):
        with shd.mesh_context(mesh):
            return shd.region(pipelined, stage_params, x_mb, like=x_mb,
                              out=shd.Out(shd.spec_of(x_mb), partial="pod"))

    return fwd

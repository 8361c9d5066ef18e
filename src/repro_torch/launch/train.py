"""End-to-end training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --smoke --steps 200 --batch 8 --seq 64

The reference's flags, plus `--device` (default `cuda`; `cpu` on request;
without CUDA, `cuda` raises). FSDP sharding, remat, asynchronous
checkpoints with restart (`--ckpt-dir`, `--ckpt-every`, `--resume`), and
optional int8 gradient compression with error feedback
(`--compress-grads`). Training runs inside the mesh's context with the
params distributed over it (FSDP), as the reference's does:

- `--mesh host` (default): every rank of the running process group as a
  (n, 1) ("data", "model") mesh; without a group, a one-rank group of this
  process (NCCL on the card, gloo on the CPU; no port), closed at the end.
- `--mesh 16x16` / `2x16x16`: the production meshes, over a process group
  of 256 / 512 ranks (the running one, or one started from torchrun's
  environment, each rank on its `LOCAL_RANK`'s card); otherwise they
  raise, naming the ranks they need.

`main` returns the losses and the final state, so a caller in the same
process can read them.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import token_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import (compress_with_feedback,
                                                 init_error_state)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import TrainRunner
from repro_torch.launch.mesh import (init_local_group, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.training.steps import make_loss_fn, value_and_grad


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="host", choices=["host", "16x16",
                                                       "2x16x16"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    own_group = not dist.is_initialized()
    if args.mesh != "host":
        if own_group and "WORLD_SIZE" in os.environ:
            dist.init_process_group()          # torchrun's environment
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "2x16x16")
        except RuntimeError:
            if own_group and dist.is_initialized():
                dist.destroy_process_group()
            raise
    dev = resolve_device(args.device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if args.mesh == "host":
        init_local_group(dev.type)
        mesh = make_host_mesh()
    try:
        with shd.mesh_context(mesh, fsdp=True):
            return _train(args, dev, mesh)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, dev, mesh) -> dict:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    gen = torch.Generator(dev).manual_seed(0)
    params = shd.distribute_params(model.init(gen, device=dev), mesh,
                                   fsdp=True)
    opt_state = adamw_init(params)
    err = init_error_state(params) if args.compress_grads else None
    vg = value_and_grad(make_loss_fn(model, remat=True, ce_chunk=512))

    def step_fn(state, batch):
        params, opt_state, err = state
        loss, grads = vg(params, batch)
        if err is not None:
            grads, err = compress_with_feedback(grads, err)
        params, opt_state = adamw_update(grads, opt_state, params,
                                         lr=args.lr)
        return (params, opt_state, err), {"loss": loss}

    state = (params, opt_state, err)
    ckpt = Checkpointer(args.ckpt_dir, keep=2, every=args.ckpt_every)
    runner = TrainRunner(step_fn, ckpt, state)
    if args.resume:
        if runner.restore_if_available(state):
            print(f"resumed from step {runner.step}")

    if cfg.is_encoder_decoder:
        # the reference's CLI feeds token batches only; an encoder-decoder's
        # loss needs frames too, which no data source here makes
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: its loss takes (frames, "
            "tokens) batches, and this CLI feeds token batches only; train "
            "it through training.steps with a batch that holds 'frames'")
    data = token_batches(cfg.vocab_size, args.batch, args.seq)

    def batches():
        for toks, labels in data:
            yield {k: shd.distribute(torch.from_numpy(a).long().to(dev),
                                     ("data", None))
                   for k, a in (("tokens", toks), ("labels", labels))}

    losses = []
    t0 = time.time()
    runner0 = runner.step

    def cb(step, metrics):
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt/max(step-runner0,1)*1e3:.0f} ms/step)", flush=True)

    state = runner.run(batches(), args.steps, metrics_cb=cb)
    if losses:
        print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")
    return {"losses": losses, "state": state, "start_step": runner0,
            "step": runner.step}


if __name__ == "__main__":
    main()

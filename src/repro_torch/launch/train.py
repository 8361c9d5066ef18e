"""End-to-end training CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --smoke --steps 200 --batch 8 --seq 64

The reference's flags, plus `--device` (default `cuda`; `cpu` on request;
without CUDA, `cuda` raises). Remat, asynchronous checkpoints with
restart (`--ckpt-dir`, `--ckpt-every`, `--resume`), and optional int8
gradient compression with error feedback (`--compress-grads`). One
device: `--mesh host`; the pod meshes (`16x16`, `2x16x16`) arrive with the
mesh/sharding slice and raise. `main` returns the losses and the final
state, so a caller in the same process can read them.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.pipeline import token_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import (compress_with_feedback,
                                                 init_error_state)
from repro_torch.distributed.fault_tolerance import TrainRunner
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
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the pod meshes arrive with the port's "
            "mesh/sharding slice; the port trains on one device (--mesh "
            "host)")
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    gen = torch.Generator(dev).manual_seed(0)
    params = model.init(gen, device=dev)
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
            yield {"tokens": torch.from_numpy(toks).long().to(dev),
                   "labels": torch.from_numpy(labels).long().to(dev)}

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

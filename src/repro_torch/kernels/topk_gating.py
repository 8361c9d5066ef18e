"""Fused softmax + top-k router gating.

On a CUDA tensor `topk_gating` launches the hand-written Hopper kernel
(`csrc/topk_gating.cu`, one warp per row); on a CPU tensor it runs the
plain version (`kernels.ref.topk_gating_ref`), which follows the kernel's
selection rule. Any other device raises.

The kernel runs for a few microseconds, so the wrapper keeps its own host
work small: one output allocation viewed as gates and ids, one read of the
current stream, no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBS
from repro_torch.kernels.ref import topk_gating_ref

MAX_EXPERTS = 256
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def topk_gating(logits: torch.Tensor, k: int, *, norm: bool = True):
    """logits: (T, E) -> (gates (T, k) fp32, ids (T, k) int32): softmax in
    fp32, then k first-max rounds (ties to the lowest index); with `norm`
    the gates are divided by max(their sum, 1e-9). E <= 256 and
    1 <= k <= E. The kernel reads fp32 or bf16 logits; the plain version
    any float dtype.

    Launches on the current CUDA stream and counts each launch in
    `topk_gating.launches`."""
    dev = logits.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"topk_gating runs on cuda or cpu, not {dev}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    T, E = logits.shape
    if E > MAX_EXPERTS or not 1 <= k <= E:
        raise ValueError(f"topk_gating needs E <= {MAX_EXPERTS} and "
                         f"1 <= k <= E, got E={E}, k={k}")
    if dev.type == "cpu":
        return topk_gating_ref(logits, k, norm)
    if logits.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16 on the card, "
                        f"got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    out = torch.empty(2 * T * k, dtype=torch.float32, device=dev)
    gates = out[:T * k].view(T, k)
    ids = out[T * k:].view(torch.int32).view(T, k)
    if T == 0:
        return gates, ids
    err = LIBS.get("topk_gating").topk_gating_launch(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        gates.data_ptr(), ids.data_ptr(), T, E, k, int(norm),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_gating launch failed with CUDA error {err}")
    topk_gating.launches += 1
    return gates, ids


topk_gating.launches = 0

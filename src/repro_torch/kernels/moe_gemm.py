"""Grouped expert SwiGLU FFN (the MoE compute over per-expert buffers).

On a CUDA tensor `expert_ffn` launches the hand-written Hopper kernel
(`csrc/expert_ffn.cu`, the tiled GEMM `slot_ffn` uses, without the slot
table); on a CPU tensor it runs the plain version
(`kernels.ref.expert_ffn_ref`) with the same rounding points. bf16 and f32
run on the card (f32 through a 3xTF32 tensor-core GEMM over the same
tiles), as in the reference; any other dtype or device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import LIBS
from repro_torch.kernels.ref import expert_ffn_ref
from repro_torch.kernels.slot_gather import KERNEL_DTYPES


def _check(x, w_gate, w_up, w_down):
    if x.dim() != 3 or w_gate.dim() != 3:
        raise ValueError("x must be (E, C, D) and the weights (E, D, F) / "
                         "(E, F, D)")
    E, C, D = x.shape
    F = w_gate.shape[-1]
    for name, t, shape in (("w_gate", w_gate, (E, D, F)),
                           ("w_up", w_up, (E, D, F)),
                           ("w_down", w_down, (E, F, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if x.device.type == "cpu":
        return
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be bfloat16 or float32 on the card, got "
                        f"{x.dtype}")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} as x, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if D % 8 or F % 8:
        raise ValueError(f"D={D} and F={F} must be multiples of 8 "
                         "(16-byte TMA strides)")


def expert_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D); w_gate / w_up: (E, D, F); w_down: (E, F, D). Returns
    (E, C, D) fp32: g, u in fp32, h = silu(g) * u rounded to x's dtype,
    h @ Wd in fp32. Any C >= 1; on the card bf16 or f32 with D, F
    multiples of 8.

    Launches on the current CUDA stream and counts each launch in
    `expert_ffn.launches`."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"expert_ffn runs on cuda or cpu, not {x.device}")
    _check(x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return expert_ffn_ref(x, w_gate, w_up, w_down)
    E, C, D = x.shape
    F = w_gate.shape[-1]
    out = torch.empty((E, C, D), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib = LIBS.get("expert_ffn")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = (lib.expert_ffn_launch if x.dtype == torch.bfloat16
              else lib.expert_ffn_f32_launch)
    err = launch(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        h.data_ptr(), out.data_ptr(), E, C, D, F, stream)
    if err != 0:
        raise RuntimeError(f"expert_ffn launch failed with CUDA error {err}")
    expert_ffn.launches += 1
    return out


expert_ffn.launches = 0

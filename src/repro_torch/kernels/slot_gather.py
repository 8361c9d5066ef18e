"""Slot-indirect expert FFN (ExpertFlow's expert-cache read path).

The expert weights live in a bounded slot buffer (S < E slots); an
(E,) expert -> slot table says where each expert's weights sit. On a CUDA
tensor `slot_ffn` launches the hand-written Hopper kernel
(`csrc/slot_ffn.cu`), which chases the table inside the kernel; on a CPU
tensor it runs the plain version (`kernels.ref.slot_ffn_ref`) with the same
arithmetic. bf16 and f32 run on the card, as in the reference; any other
dtype or device raises. With per-expert row counts the kernel
computes only the rows that hold tokens, and an expert whose count is 0
(empty, or not resident) reads neither its rows nor its weights.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import LIBS
from repro_torch.kernels.ref import slot_ffn_ref

KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, slot_of_expert, s_gate, s_up, s_down, counts):
    E, C, D = x.shape
    S, D2, F = s_gate.shape
    if D2 != D or tuple(s_up.shape) != (S, D, F) \
            or tuple(s_down.shape) != (S, F, D):
        raise ValueError(
            f"slot buffer shapes {tuple(s_gate.shape)}, {tuple(s_up.shape)}, "
            f"{tuple(s_down.shape)} do not fit x {tuple(x.shape)}")
    if tuple(slot_of_expert.shape) != (E,):
        raise ValueError(f"slot_of_expert must be ({E},), got "
                         f"{tuple(slot_of_expert.shape)}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    for name, t in (("x", x), ("s_gate", s_gate), ("s_up", s_up),
                    ("s_down", s_down)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must be {x.dtype} as x, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if slot_of_expert.dtype != torch.int32 or not slot_of_expert.is_contiguous() \
            or slot_of_expert.device != x.device:
        raise TypeError("slot_of_expert must be a contiguous int32 tensor on "
                        "x's device")
    if counts is not None and (
            counts.dtype != torch.int32 or not counts.is_contiguous()
            or counts.device != x.device or tuple(counts.shape) != (E,)):
        raise TypeError(f"counts must be a contiguous int32 ({E},) tensor on "
                        "x's device")
    if D % 8 or F % 8:
        raise ValueError(f"D={D} and F={F} must be multiples of 8 "
                         "(16-byte TMA strides)")


def slot_ffn(x: torch.Tensor, slot_of_expert: torch.Tensor,
             s_gate: torch.Tensor, s_up: torch.Tensor, s_down: torch.Tensor,
             counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (E, C, D) dispatch buffer; slot_of_expert: (E,) int32 slots in
    [0, S); slot buffers (S, D, F) / (S, F, D) of x's dtype, bf16 (the TMA +
    wgmma GEMM) or f32 (a 3xTF32 tensor-core GEMM over the same tiles). Returns
    (E, C, D) fp32.

    `counts`: optional (E,) int32 tensor on x's device, the rows of x[e]
    that hold tokens (its first counts[e] rows). None computes all C rows,
    the reference's function exactly. With counts, rows at or past
    counts[e] are neither read nor written and their output is
    unspecified (the plain version writes zeros there); an expert with
    count 0 reads no weights, so its slot entry may point anywhere.

    Launches on the current CUDA stream and counts each launch in
    `slot_ffn.launches`."""
    if x.device.type == "cpu":
        return slot_ffn_ref(x, slot_of_expert, s_gate, s_up, s_down, counts)
    if x.device.type != "cuda":
        raise ValueError(f"slot_ffn runs on cuda or cpu, not {x.device}")
    _check(x, slot_of_expert, s_gate, s_up, s_down, counts)
    E, C, D = x.shape
    S, _, F = s_gate.shape
    out = torch.empty((E, C, D), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib = LIBS.get("slot_ffn")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    launch = (lib.slot_ffn_launch if x.dtype == torch.bfloat16
              else lib.slot_ffn_f32_launch)
    err = launch(
        x.data_ptr(), slot_of_expert.data_ptr(),
        None if counts is None else counts.data_ptr(), s_gate.data_ptr(),
        s_up.data_ptr(), s_down.data_ptr(), h.data_ptr(), out.data_ptr(),
        E, C, D, F, S, stream)
    if err != 0:
        raise RuntimeError(f"slot_ffn launch failed with CUDA error {err}")
    slot_ffn.launches += 1
    return out


slot_ffn.launches = 0

"""The port's public kernel API, under the reference's names and positional
arguments (`repro.kernels.ops`), without its TPU-only keywords
(`interpret`, `block_*`).

Each entry is the kernel's wrapper itself: a CPU tensor runs the plain
version in `kernels.ref`, a CUDA tensor launches the hand-written Hopper
kernel (and counts it in the wrapper's `.launches`), any other device
raises. The `*_ref` names re-export the plain versions.
"""
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.decode_superkernel import (fused_decode_attention,
                                                    fused_mla_decode_attention,
                                                    fused_moe_entry)
from repro_torch.kernels.moe_gemm import expert_ffn
from repro_torch.kernels.slot_gather import slot_ffn
from repro_torch.kernels.topk_gating import topk_gating as topk

__all__ = ["expert_ffn", "topk", "slot_ffn", "fused_moe_entry",
           "fused_decode_attention", "fused_mla_decode_attention",
           "expert_ffn_ref", "topk_ref", "slot_ffn_ref", "fused_moe_entry_ref",
           "fused_decode_attention_ref", "fused_mla_decode_attention_ref"]

expert_ffn_ref = _ref.expert_ffn_ref
topk_ref = _ref.topk_gating_ref
slot_ffn_ref = _ref.slot_ffn_ref
fused_moe_entry_ref = _ref.fused_moe_entry_ref
fused_decode_attention_ref = _ref.fused_decode_attention_ref
fused_mla_decode_attention_ref = _ref.fused_mla_decode_attention_ref

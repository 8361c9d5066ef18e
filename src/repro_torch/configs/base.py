"""Model configuration dataclasses.

Every architecture in the framework is described by a single `ModelConfig`.
Config files under ``repro.configs`` export ``CONFIG`` (the full published
architecture) and ``smoke()`` (a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (router + expert shapes)."""

    num_experts: int
    top_k: int
    d_expert: int                 # hidden width of each routed expert FFN
    num_shared_experts: int = 0   # always-on shared experts (DeepSeek/Qwen style)
    d_shared: int = 0             # hidden width of the fused shared-expert FFN
    router_norm_topk: bool = True  # renormalize gate weights over the top-k
    capacity_factor: float = 1.25  # EP dispatch buffer slack
    moe_every: int = 1            # a layer is MoE iff (layer % moe_every == moe_offset)
    moe_offset: int = 0
    first_dense_layers: int = 0   # leading dense layers (DeepSeek style)

    @property
    def bytes_per_expert_bf16(self) -> int:
        # gate + up + down projections of one routed expert, bf16
        return 0  # filled in by ModelConfig.expert_bytes (needs d_model)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention dims (DeepSeek-V2 / MiniCPM3)."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads

    # --- attention flavour -------------------------------------------------
    attention: str = "gqa"        # gqa | mla | none
    window_size: int = 0          # 0 = global; >0 = sliding window
    local_global_pattern: Tuple[str, ...] = ()  # e.g. ("local","global") alternating
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    qk_norm: bool = False         # qwen3-style per-head q/k RMSNorm

    # --- sub-configs --------------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # --- hybrid / recurrent -------------------------------------------------
    # block pattern unit, tiled over depth, e.g. ("rec","rec","attn")
    block_pattern: Tuple[str, ...] = ("attn",)
    lru_width: int = 0            # RG-LRU recurrence width (0 -> d_model)
    conv1d_width: int = 4         # temporal conv in recurrent block
    # xLSTM
    slstm_at: Tuple[int, ...] = ()  # layer indices that are sLSTM (rest mLSTM)
    proj_factor: float = 2.0      # mLSTM up-projection factor

    # --- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_source_positions: int = 1500

    # --- vlm ----------------------------------------------------------------
    uses_input_embeds: bool = False  # frontend stub supplies embeddings

    # --- misc ----------------------------------------------------------------
    abs_pos: bool = False         # sinusoidal absolute positions (whisper)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_bias: bool = False
    dtype: str = "bfloat16"
    # sub-quadratic? (drives long_500k applicability)
    sub_quadratic: bool = False
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def layer_kind(self, layer_idx: int) -> str:
        """Block kind for a given depth ('attn' | 'rec' | 'mlstm' | 'slstm')."""
        if self.family == "ssm":
            return "slstm" if layer_idx in self.slstm_at else "mlstm"
        pat = self.block_pattern
        return pat[layer_idx % len(pat)]

    def attn_window(self, layer_idx: int) -> int:
        """Sliding-window size for a layer (0 = global)."""
        if self.local_global_pattern:
            kind = self.local_global_pattern[layer_idx % len(self.local_global_pattern)]
            return self.window_size if kind == "local" else 0
        return self.window_size

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        m = self.moe
        if layer_idx < m.first_dense_layers:
            return False
        return (layer_idx % m.moe_every) == m.moe_offset

    # ---- sizes --------------------------------------------------------
    def expert_bytes(self, bytes_per_param: int = 2) -> int:
        """Bytes of ONE routed expert (gate+up+down), the paper's E_s."""
        if self.moe is None:
            return 0
        m = self.moe
        return 3 * self.d_model * m.d_expert * bytes_per_param

    def param_count(self) -> int:
        """Approximate total parameter count (embedding included)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer_attn = 0
        per_layer_ffn = 0
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attention == "mla" and self.mla is not None:
                    c = self.mla
                    qk_hd = c.qk_nope_head_dim + c.qk_rope_head_dim
                    qin = d * c.q_lora_rank + c.q_lora_rank * self.num_heads * qk_hd \
                        if c.q_lora_rank else d * self.num_heads * qk_hd
                    kvin = d * (c.kv_lora_rank + c.qk_rope_head_dim) + \
                        c.kv_lora_rank * self.num_heads * (c.qk_nope_head_dim + c.v_head_dim)
                    out = self.num_heads * c.v_head_dim * d
                    per_layer_attn += qin + kvin + out
                else:
                    per_layer_attn += d * (self.num_heads * hd) + \
                        2 * d * (self.num_kv_heads * hd) + (self.num_heads * hd) * d
            elif kind == "rec":
                w = self.lru_width or d
                per_layer_attn += 2 * d * w + w * d + 3 * w  # in/gate/out + lru params
            elif kind in ("mlstm", "slstm"):
                up = int(d * self.proj_factor)
                per_layer_attn += 2 * d * up + up * d + 4 * d * d  # proj + qkv/gates
            if self.is_moe_layer(i):
                m = self.moe
                per_layer_ffn += m.num_experts * 3 * d * m.d_expert
                per_layer_ffn += m.num_shared_experts * 3 * d * (m.d_shared or m.d_expert)
                per_layer_ffn += d * m.num_experts  # router
            elif self.d_ff:
                per_layer_ffn += 3 * d * self.d_ff
        n += per_layer_attn + per_layer_ffn
        if self.is_encoder_decoder:
            # encoder self-attn + ffn + decoder cross-attn
            enc = self.encoder_layers * (4 * d * self.num_heads * hd + 3 * d * self.d_ff)
            xattn = L * (4 * d * self.num_heads * hd)
            n += enc + xattn
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        inactive = 0
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                inactive += (m.num_experts - m.top_k) * 3 * self.d_model * m.d_expert
        return full - inactive


def reduce_config(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
                  heads: int = 4, kv_heads: int = 0, d_ff: int = 128,
                  vocab: int = 512, experts: int = 8, top_k: int = 2,
                  d_expert: int = 32) -> ModelConfig:
    """Shrink a config to a same-family smoke-test variant."""
    kv = kv_heads or max(1, heads // max(1, cfg.num_heads // max(cfg.num_kv_heads, 1)))
    moe = None
    if cfg.moe is not None:
        tk = min(top_k, experts)
        moe = dataclasses.replace(
            cfg.moe, num_experts=experts, top_k=tk,
            d_expert=d_expert,
            d_shared=d_expert if cfg.moe.num_shared_experts else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            # drop-free capacity so decode == forward exactly in tests
            capacity_factor=float(experts) / tk,
        )
    mla = None
    if cfg.mla is not None:
        mla = MLAConfig(q_lora_rank=(32 if cfg.mla.q_lora_rank else 0),
                        kv_lora_rank=32, qk_nope_head_dim=16,
                        qk_rope_head_dim=8, v_head_dim=16)
    hd = 0
    if cfg.head_dim:
        hd = max(8, d_model // heads)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=d_ff if cfg.d_ff else 0,
        vocab_size=vocab,
        moe=moe,
        mla=mla,
        lru_width=(d_model if cfg.lru_width else 0),
        window_size=min(cfg.window_size, 16) if cfg.window_size else 0,
        encoder_layers=min(cfg.encoder_layers, layers),
        max_source_positions=64 if cfg.is_encoder_decoder else cfg.max_source_positions,
        slstm_at=tuple(i for i in cfg.slstm_at if i < layers),
    )

"""DeepSeek-V2-Lite — the paper's primary evaluation model.

[arXiv:2405.04434] 27L (first layer dense) d_model=2048 16H, MLA
(kv_lora=512, qk_nope=128, qk_rope=64, v=128, no q-lora), MoE: 64 routed
experts top-6 + 2 shared, expert d_ff=1408, dense-layer d_ff=10944,
vocab=102400.
"""
from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                      reduce_config)

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,              # only the first (dense) layer uses this
    vocab_size=102400,
    attention="mla",
    mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408,
                  num_shared_experts=2, d_shared=1408,
                  first_dense_layers=1),
)


def smoke():
    return reduce_config(CONFIG, layers=3, d_model=64, heads=4, kv_heads=4,
                         d_ff=128, vocab=512, experts=8, top_k=2, d_expert=32)

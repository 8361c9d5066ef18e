"""Qwen1.5-MoE-A2.7B — paper evaluation model.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (MHA), 60 routed experts
top-4 + shared expert (5632 = 4x1408), expert d_ff=1408, vocab=151936.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen1.5-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=151936,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared_experts=4, d_shared=1408),
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=4,
                         vocab=512, experts=8, top_k=2, d_expert=32)

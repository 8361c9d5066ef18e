"""qwen3-moe-235b-a22b — 128 experts, top-8, every layer MoE.

[hf:Qwen/Qwen3-30B-A3B family; hf] 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936. qk-norm, no shared experts.
Primary ExpertFlow target architecture.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_expert=1536,
                  router_norm_topk=True),
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=2,
                         vocab=512, experts=8, top_k=2, d_expert=32)

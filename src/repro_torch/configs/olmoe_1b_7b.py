"""olmoe-1b-7b — 64 experts, top-8.

[arXiv:2409.02060; hf] 16L d_model=2048 16H (MHA kv=16) expert d_ff=1024
vocab=50304, qk-norm.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=50304,
    qk_norm=True,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024,
                  router_norm_topk=False),
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=4,
                         vocab=512, experts=8, top_k=2, d_expert=32)

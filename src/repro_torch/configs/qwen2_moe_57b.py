"""Qwen2-57B-A14B (MoE) — paper evaluation model (4-bit in the paper).

[arXiv:2407.10671] 28L d_model=3584 28H (GQA kv=4), 64 routed experts top-8
+ shared expert (20480 = 8x2560), expert d_ff=2560, vocab=151936.
The paper's INT4 quantization is modeled as bytes-per-param=0.5 in the
transfer simulator (numerics stay bf16).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="qwen2-moe-57b",
    family="moe",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=151936,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=2560,
                  num_shared_experts=8, d_shared=2560),
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=2,
                         vocab=512, experts=8, top_k=2, d_expert=32)

"""recurrentgemma-2b — RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427; hf] 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
Pattern: (rec, rec, attn) tiled; attention layers use a 2048 sliding window,
so the whole model is sub-quadratic (long_500k runs).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    window_size=2048,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    conv1d_width=4,
    rope_theta=10000.0,
    tie_embeddings=True,
    sub_quadratic=True,
    notes="Griffin blocks; embeddings scaled by sqrt(d); zero-centered norms",
)


def smoke():
    return reduce_config(CONFIG, layers=3, d_model=64, heads=4, kv_heads=1,
                         d_ff=128, vocab=512)

"""command-r-plus-104b — large dense GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01 family; unverified] 64L d_model=12288
96H (GQA kv=8) d_ff=33792 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75000000.0,
    tie_embeddings=True,
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=2,
                         d_ff=128, vocab=512)

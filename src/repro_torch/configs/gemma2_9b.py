"""gemma2-9b — local+global alternating attention, logit softcaps.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000; window 4096 on local layers; attn softcap 50,
final-logit softcap 30. Global layers are full attention -> long_500k SKIPPED.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    window_size=4096,
    local_global_pattern=("local", "global"),
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10000.0,
    tie_embeddings=True,
    notes="zero-centered norms + post-norms; embeddings scaled by sqrt(d)",
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=2,
                         d_ff=128, vocab=512)

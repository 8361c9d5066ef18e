"""llava-next-34b — VLM; anyres tiling frontend is a STUB.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] Backbone only:
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
`input_specs()` supplies precomputed patch/text embeddings (B, T, d).
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5000000.0,
    uses_input_embeds=True,
    notes="dense Yi-34B-class backbone; modality frontend stubbed",
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=2,
                         d_ff=128, vocab=512)

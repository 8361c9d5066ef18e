"""whisper-large-v3 — encoder-decoder; conv frontend STUBBED.

[arXiv:2212.04356; unverified] 32L enc + 32L dec, d_model=1280 20H (MHA)
d_ff=5120 vocab=51866. `input_specs()` provides precomputed frame embeddings
(B, frames, d) — the mel+conv frontend is a stub per the assignment.
rope_theta=0 -> sinusoidal absolute positions.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    is_encoder_decoder=True,
    encoder_layers=32,
    max_source_positions=1500,
    rope_theta=0.0,
    abs_pos=True,            # sinusoidal absolute positions
    tie_embeddings=True,
)


def smoke():
    return reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=4,
                         d_ff=128, vocab=512)

"""xlstm-1.3b — sLSTM + mLSTM blocks (7:1 mLSTM:sLSTM).

[arXiv:2405.04517; unverified] 48L d_model=2048 4H vocab=50304, d_ff=0
(the xLSTM block's internal up/down projection is the FFN). Constant-size
recurrent state -> sub-quadratic, long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, reduce_config

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    slstm_at=(0, 8, 16, 24, 32, 40),   # 1-in-8 sLSTM (7:1 ratio)
    proj_factor=2.0,
    rope_theta=0.0,
    sub_quadratic=True,
)


def smoke():
    cfg = reduce_config(CONFIG, layers=2, d_model=64, heads=4, kv_heads=4,
                        vocab=512)
    return cfg

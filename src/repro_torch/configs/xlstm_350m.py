"""xLSTM-350M — sLSTM + mLSTM blocks [arXiv:2405.04517].
24 blocks, 7:1 mLSTM:sLSTM, no separate FFN (d_ff=0)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                # xLSTM blocks carry their own projections
    vocab_size=50304,
    norm="rmsnorm",
    activation="gelu",
    ssm_kind="xlstm",
    slstm_every=8,         # one sLSTM per 8 blocks (7:1)
    source="arXiv:2405.04517",
)

"""Jamba-v0.1 52B — hybrid Mamba+attention 1:7 interleave with MoE
[arXiv:2403.19887].  32 layers, attention every 8th layer, MoE every other
layer (16 experts, top-2)."""

from repro_torch.configs.base import ArchConfig, MoEArch

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    norm="rmsnorm",
    activation="swiglu",
    ssm_kind="mamba",
    attn_every=8,          # 1 attention : 7 mamba
    attn_offset=4,         # attention sits mid-group (Jamba places it at 4)
    moe=MoEArch(num_experts=16, top_k=2, d_ff_expert=14336,
                moe_period=2, capacity_factor=1.25),
    source="arXiv:2403.19887",
)

"""GPT-3 Medium + MoE — the paper's own experimental model (Table 3):
12 layers, hidden 1024, GShard top-2 gate, intermediate 2048 experts.
Expert count is swept {8,16,32,48,64} in the benchmarks; 64 here.

``moe_period=2`` is carried for fidelity, but ``layer_plan`` ignores it
(as the reference's does), so every layer is an MoE layer."""

from repro_torch.configs.base import ArchConfig, MoEArch

CONFIG = ArchConfig(
    name="gpt3-medium-moe",
    family="moe",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=50304,
    norm="layernorm",
    activation="gelu",
    moe=MoEArch(num_experts=64, top_k=2, d_ff_expert=2048,
                moe_period=2,          # MoE every other layer (standard GShard)
                capacity_factor=2.0),  # paper Table 3, GShard gate
    source="TA-MoE paper, Table 3 [arXiv:2302.09915]",
)

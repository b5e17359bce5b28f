"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE [arXiv:2405.04434].
27 layers (first dense), 64 routed experts top-6 + 2 shared,
MLA kv_lora_rank=512."""

from repro_torch.configs.base import ArchConfig, MLAArch, MoEArch

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,            # dense first-layer FFN
    vocab_size=102400,
    norm="rmsnorm",
    activation="swiglu",
    mla=MLAArch(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                v_dim=128, q_lora_rank=0),
    moe=MoEArch(num_experts=64, top_k=6, d_ff_expert=1408,
                num_shared_experts=2, first_dense=1,
                capacity_factor=1.25),
    source="arXiv:2405.04434",
)

"""DeepSeek-V2 236B — MLA + 160-expert MoE top-6 [arXiv:2405.04434].
60 layers (first dense), q_lora_rank=1536, 2 shared experts.

About 236 B parameters (470 GB in bf16) do not fit one card; the parity
tests run it at ``reduced()`` size with ``q_lora_rank`` kept."""

from repro_torch.configs.base import ArchConfig, MLAArch, MoEArch

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,            # dense first-layer FFN
    vocab_size=102400,
    norm="rmsnorm",
    activation="swiglu",
    mla=MLAArch(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                v_dim=128, q_lora_rank=1536),
    moe=MoEArch(num_experts=160, top_k=6, d_ff_expert=1536,
                num_shared_experts=2, first_dense=1,
                capacity_factor=1.25),
    source="arXiv:2405.04434",
)

"""InternVL2-26B — VLM: InternViT (stub frontend) + InternLM2-20B backbone
[arXiv:2404.16821].  The language model consumes projected patch
embeddings; the vision tower is the sanctioned stub (``models/vlm.py``)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    norm="rmsnorm",
    activation="swiglu",
    rope_theta=1e6,
    frontend="vision",
    frontend_len=256,      # projected ViT patch embeddings per image
    source="arXiv:2404.16821",
)

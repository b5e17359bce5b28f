"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679].
Its 256k vocabulary is the widest unembedding the port serves."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    norm="rmsnorm",
    activation="swiglu",
    source="arXiv:2407.14679",
)

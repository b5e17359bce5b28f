"""Whisper-tiny — encoder-decoder audio model [arXiv:2212.04356].
The conv/mel frontend is the sanctioned stub: ``models/whisper.py``
provides frame embeddings [B, 1500, 384] directly to the 4-layer
encoder."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,          # decoder layers
    enc_layers=4,          # encoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    activation="gelu",
    frontend="audio",
    frontend_len=1500,     # 30 s of audio at 50 Hz after the conv stub
    source="arXiv:2212.04356",
)

"""Architecture configuration dataclasses and the arch registry (the
counterpart of ``repro/configs/base.py``: the same eleven configs).

``ArchConfig.reduced()`` yields the CPU smoke-test variant (<=2 layers,
or one whole mixer group of a hybrid or of xLSTM; d_model<=256, <=4
experts, the MLA ranks cut, <=2 encoder layers, <=16 frontend positions)
of the same family.
``dtype`` stays a string; ``torch_dtype`` maps it onto a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEArch:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    moe_period: int = 1          # MoE FFN every `period` layers (1 = all)
    first_dense: int = 0         # leading layers keep a dense FFN
    capacity_factor: float = 1.25
    dispatch_override: tuple = ()


@dataclasses.dataclass(frozen=True)
class MLAArch:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128
    q_lora_rank: int = 0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    norm: str = "rmsnorm"         # rmsnorm | nonparam_ln | layernorm
    activation: str = "swiglu"
    rope_theta: float = 1e4
    sliding_window: int = 0       # 0 = full attention
    qkv_bias: bool = False
    # the unembedding is always params["embed"] transposed, in both
    # packages: the field is the published config's, and changes nothing
    tie_embeddings: bool = False
    moe: MoEArch | None = None
    mla: MLAArch | None = None
    # hybrid (jamba): attention mixer at layer i when i % attn_every ==
    # attn_offset, else the SSM mixer.  attn_every=1 -> pure attention.
    attn_every: int = 1
    attn_offset: int = 0
    ssm_kind: str = ""            # "mamba" | "xlstm"
    slstm_every: int = 0          # xlstm: one sLSTM block per this many
    # encoder-decoder (whisper)
    enc_layers: int = 0
    # modality frontend stub: embeddings of shape [B, frontend_len, width]
    frontend: str | None = None   # "audio" | "vision"
    frontend_len: int = 0
    dtype: str = "bfloat16"
    source: str = ""              # citation

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the reference's long_500k shape: recurrent and MLA
        models, dense and vision models through a sliding-window variant;
        not the encoder-decoder, whose contexts are bounded."""
        if self.family in ("ssm", "hybrid") or self.mla is not None:
            return True
        return self.family != "audio"

    def reduced(self) -> ArchConfig:
        """Smoke-test variant: same family/structure, tiny dims (the same
        cuts as the reference's ``ArchConfig.reduced``)."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        layers = min(self.num_layers, max(2, self.attn_every))
        if self.family == "hybrid":       # keep one full mixer group
            layers = self.attn_every
        if self.ssm_kind == "xlstm" and self.slstm_every:
            layers = min(self.num_layers, self.slstm_every)
        moe = self.moe
        if moe:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2),
                d_ff_expert=min(moe.d_ff_expert, 128),
                num_shared_experts=min(moe.num_shared_experts, 1),
                first_dense=min(moe.first_dense, 1))
        mla = self.mla
        if mla:
            mla = dataclasses.replace(mla, kv_lora_rank=64, qk_nope_dim=32,
                                      qk_rope_dim=16, v_dim=32,
                                      q_lora_rank=0)
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=layers, d_model=d,
            num_heads=heads, num_kv_heads=kv, head_dim=0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            enc_layers=min(self.enc_layers, 2),
            frontend_len=(min(self.frontend_len, 16)
                          if self.frontend_len else 0),
            moe=moe, mla=mla, dtype="float32")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run hyperparameters (the reference's ``RunConfig``, same
    fields and defaults)."""
    seq_len: int = 4096
    global_batch: int = 256
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    aux_weight: float = 1.0       # paper: 1.0
    aux_mode: str = "ta"          # lb | ta | hir | none
    seed: int = 0
    microbatch: int = 0           # 0 = no grad accumulation
    remat: bool = False
    dispatch: str = "a2a"
    a2a_num_chunks: int = 0
    dispatch_override: tuple = ()
    use_pallas: bool | None = None   # None = auto (CUDA kernels on the card)
    wire_codec: str = ""
    resilience: object | None = None
    topology: tuple = ()

    def mesh_axis_sizes(self) -> tuple:
        """Outermost-first hierarchy sizes of ``topology`` (empty tuple
        when no spec was given)."""
        if not self.topology:
            return ()
        from repro_torch.core.topology import axis_sizes_from_spec
        return axis_sizes_from_spec(self.topology)


ARCH_IDS = (
    "jamba_v0_1_52b", "internlm2_1_8b", "internvl2_26b", "olmo_1b",
    "whisper_tiny", "deepseek_v2_lite_16b", "xlstm_350m",
    "deepseek_v2_236b", "granite_3_2b", "minitron_4b",
    "gpt3_medium_moe",            # the paper's own model
)


def normalize_arch_id(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    name = normalize_arch_id(arch_id)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}


# The four input shapes of the dry-run (a copy of the reference's
# ``INPUT_SHAPES``): global batch and sequence length of each kind.
INPUT_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

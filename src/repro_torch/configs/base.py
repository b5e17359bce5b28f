"""Architecture configuration dataclasses and the arch registry (the
counterpart of ``repro/configs/base.py``; only the configs this port
serves are registered).

``ArchConfig.reduced()`` yields the CPU smoke-test variant (<=2 layers,
d_model<=256, <=4 experts) of the same family.  ``dtype`` stays a string;
``torch_dtype`` maps it onto a ``torch.dtype``.
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
    moe: MoEArch | None = None
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

    def reduced(self) -> ArchConfig:
        """Smoke-test variant: same family/structure, tiny dims (the same
        cuts as the reference's ``ArchConfig.reduced``)."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        layers = min(self.num_layers, 2)
        moe = self.moe
        if moe:
            moe = dataclasses.replace(
                moe, num_experts=min(moe.num_experts, 4),
                top_k=min(moe.top_k, 2),
                d_ff_expert=min(moe.d_ff_expert, 128),
                num_shared_experts=min(moe.num_shared_experts, 1),
                first_dense=min(moe.first_dense, 1))
        return dataclasses.replace(
            self, name=self.name + "-smoke", num_layers=layers, d_model=d,
            num_heads=heads, num_kv_heads=kv, head_dim=0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=(min(self.sliding_window, 64)
                            if self.sliding_window else 0),
            moe=moe, dtype="float32")


ARCH_IDS = ("gpt3_medium_moe",)


def normalize_arch_id(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ArchConfig:
    name = normalize_arch_id(arch_id)
    if name not in ARCH_IDS:
        raise ValueError(f"arch {arch_id!r} is not ported yet; ported: "
                         f"{ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG

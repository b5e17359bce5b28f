"""The shapes at which the kernel packages register their launch layouts
(``backend.register_kernel``): the layouts the port's main paths give
each kernel at ``gpt3_medium_moe``'s full width (d 1024, 64 experts top-2
of f 2048, gelu), computed by the functions the paths call:
``models.model.make_plan``, ``transport.plan_stages`` and the engine's
capacity clamp and chunk alignment.

* ``staged(sizes, global_batch, num_chunks)``: one rank's slot and
  segment tables of the staged ``a2a`` paths (sequence 512), e.g. the
  2x2 training plan (caps (120, 16): 4864 slots) and chunk 0 of its
  8-chunk pipelined plan (608 slots);
* ``local(global_batch)``: the one-rank fused layout (one segment an
  expert, as wide as the capacity);
* ``gathered(tokens, ep_world)``: the gather path's dense [E_l, Tg] slot
  layout.

On a tensor-parallel world (``TP_MODEL`` model ranks) the expert FFN's
width is ``f / TP_MODEL`` a rank and attention holds ``1 / TP_MODEL`` of
the heads: K4 and K5 register those layouts beside the others
(gpt3_medium_moe's f 1024 and 8 of its 16 heads; Minitron-4B's 12 of 24
heads over 4 of 8 KV heads at 128; DeepSeek-V2-Lite's experts at f 704
and Jamba's at f 7168 through the gather path; Whisper's encoder at 3 of
6 heads, InternVL2's prefill at 24 of 48 over 4 of 8 KV heads), and on
the EP x TP world (``EP_TP_SIZES`` x ``TP_MODEL``: data 2, model 2) K1,
K2, K3 and K7 register rank 0's staged layouts at f 1024
(``staged(EP_TP_SIZES, model=TP_MODEL)``).

The repo's other MoE models on the 2x2 EP world register theirs too:
DeepSeek-V2-Lite's (d 2048, 16 experts of f 1408 a rank, swiglu, top-6)
and DeepSeek-V2-236B's (d 5120, 40 experts of f 1536 a rank) at
``staged(arch_id=..., global_batch=DSV2_22_BATCH)`` and their pipelined
chunk 0 (K1, K2 at top-6, K3, K7; ``dsv2_staged``), and the gather
layouts of the 2x2 serving world (K4: DeepSeek-V2-Lite's 16 experts a
rank, DeepSeek-V2-236B's 40, Jamba's 4 of f 14336).  Jamba's one-rank
training layout (16 experts of f 14336, ``local(arch_id=JAMBA_ID)``)
registers K4's too.

Imports of the model stack happen inside the functions, so importing a
kernel package stays light.
"""

from __future__ import annotations

import dataclasses
import functools

ARCH_ID = "gpt3_medium_moe"
TRAIN_SEQ = 512
#: the model axis of the tensor-parallel layouts
TP_MODEL = 2
#: the hierarchy of the EP x TP world (experts over data 2, each expert's
#: width over the model axis)
EP_TP_SIZES = (2,)
#: the other MoE models on the 2x2 EP world: DeepSeek-V2-Lite trains at
#: global batch DSV2_22_BATCH (512 tokens a rank), and DeepSeek-V2-236B's
#: kernels are checked at that plan's layouts; all three serve 8 slots in
#: packs of 4 prompts of 128 (Jamba's scan prefill steps gather 4 rows)
DSV2_ID, JAMBA_ID = "deepseek_v2_lite_16b", "jamba_v0_1_52b"
DSV2_236B_ID = "deepseek_v2_236b"
DSV2_22_BATCH = 4


@dataclasses.dataclass(frozen=True)
class Staged:
    """One rank's view of a staged plan: its tokens, top-k, widths and
    the segment table of one chunk's delivered buffer (``slots``
    rows)."""

    tokens: int
    top_k: int
    d: int
    f: int
    seg_offsets: tuple
    seg_experts: tuple

    @property
    def slots(self) -> int:
        return self.seg_offsets[-1]


def arch(arch_id: str = ARCH_ID):
    from repro_torch.configs.base import get_config
    return get_config(arch_id)


@functools.lru_cache(maxsize=None)
def staged(sizes=(2, 2), global_batch: int = 8,
           num_chunks: int = 1, model: int = 1,
           arch_id: str = ARCH_ID) -> Staged:
    """Rank 0's layout of ``arch_id``'s staged plan over the EP world
    ``sizes`` at sequence 512 and ``global_batch`` (chunk 0 of
    ``num_chunks``); a model axis of ``model`` splits each expert's width
    (the plan is the hierarchy's)."""
    import math

    from repro_torch.core import capacity
    from repro_torch.core.dispatch import transport
    from repro_torch.launch import mesh
    from repro_torch.models import model as model_lib

    a = arch(arch_id)
    world = mesh.recording_world(sizes)
    plan = model_lib.make_plan(a, world, TRAIN_SEQ, global_batch, "ta")
    if num_chunks > 1:
        plan = capacity.align_to_chunks(plan, num_chunks)
    ep = model_lib.make_ep_spec(a, world)
    T = global_batch * TRAIN_SEQ // math.prod(sizes)
    E_l = a.moe.num_experts // ep.ep_world
    widths = []
    for stage in transport.plan_stages(plan, ep):
        cap = min(int(stage.cap), T)                   # routing.select
        cap = -(-cap // num_chunks) * num_chunks       # pad_selection
        widths.append((stage.num_dests, cap // num_chunks))
    offs, exps = transport.stage_segments(E_l, tuple(widths))
    return Staged(tokens=T, top_k=a.moe.top_k, d=a.d_model,
                  f=a.moe.d_ff_expert // model, seg_offsets=offs,
                  seg_experts=exps)


@functools.lru_cache(maxsize=None)
def pipelined_chunks(arch_id: str = ARCH_ID, sizes=(2, 2),
                     global_batch: int = 8) -> int:
    """The overlap model's chunk count for ``arch_id``'s pipelined plan
    over the int8 wire on the EP world ``sizes`` (``model.build_ctx``)."""
    from repro_torch.launch import mesh
    from repro_torch.models import model as model_lib
    return model_lib.build_ctx(
        arch(arch_id), mesh.recording_world(sizes), seq_len=TRAIN_SEQ,
        global_batch=global_batch, dispatch="a2a_pipelined",
        wire_codec="int8", device="cpu").a2a_num_chunks


def dsv2_staged(pipelined: bool = False, arch_id: str = DSV2_ID) -> Staged:
    """A DeepSeek-V2 model's (``arch_id``: DeepSeek-V2-Lite or -236B)
    rank-0 layout on the 2x2 EP world at DSV2_22_BATCH: the a2a plan's,
    or chunk 0 of the int8 pipelined plan's."""
    k = (pipelined_chunks(arch_id, (2, 2), DSV2_22_BATCH) if pipelined
         else 1)
    return staged((2, 2), DSV2_22_BATCH, num_chunks=k, arch_id=arch_id)


@functools.lru_cache(maxsize=None)
def local(global_batch: int = 4, arch_id: str = ARCH_ID) -> tuple:
    """``(tokens, seg_offsets, seg_experts)`` of ``arch_id``'s one-rank
    fused layout (``engine.local_layout``): one segment an expert, as wide
    as the clamped capacity."""
    from repro_torch.core.dispatch import transport
    from repro_torch.launch import mesh
    from repro_torch.models import model

    a = arch(arch_id)
    world = mesh.recording_world((1,))
    plan = model.make_plan(a, world, TRAIN_SEQ, global_batch, "ta")
    T = global_batch * TRAIN_SEQ
    (stage,) = transport.plan_stages(plan, model.make_ep_spec(a, world))
    width = min(int(stage.cap), T)
    E = a.moe.num_experts
    return T, transport.expert_segments(E, width), tuple(range(E))


def gathered(tokens: int, ep_world: int = 1,
             arch_id: str = ARCH_ID) -> tuple:
    """``(seg_offsets, seg_experts)`` of the gather path's slot layout:
    ``E / ep_world`` local experts (of ``arch_id``) over ``tokens``
    gathered tokens."""
    from repro_torch.core.dispatch import transport

    E_l = arch(arch_id).moe.num_experts // ep_world
    return transport.expert_segments(E_l, tokens), tuple(range(E_l))

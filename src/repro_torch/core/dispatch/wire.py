"""Wire codecs: the payload encodings of the dispatch all-to-alls (the
counterpart of ``repro/core/dispatch/wire.py``).

A :class:`WireCodec` says what travels over the a2a wire: the payload
dtype, whether a per-segment f32 scale sideband rides the chain, and
whether delivered rows also compute in low precision.  One codec object
is read by ``transport.A2ATransport`` (encode once before the hop chain,
move payload and scale through the same chain, decode after the final
transpose) and by ``capacity.a2a_bytes`` / ``core.comm_model`` (the chunk
count is solved against the bytes that hit the wire).

Scale layout: one f32 scale per (destination, expert) ``[C, d]`` block,
shaped ``[*sizes, E_l]`` before the chain, the shape of the
``dispatch_counts`` exchange, so it lands as ``[E_l, num_dests]`` beside
the valid-row counts.  Routing's zero-filled slack rows never raise a
block's absmax.

Dtype names are those of the reference (``"bfloat16"``, ``"int8"``,
``"float8_e4m3fn"``), which are also torch's attribute names.
"""

from __future__ import annotations

import dataclasses

import torch


def _torch_dtype(name: str) -> torch.dtype | None:
    dt = getattr(torch, name, None)
    return dt if isinstance(dt, torch.dtype) else None


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Base codec.  ``scaled``: a per-segment f32 scale sideband rides the
    chain.  ``quantize_compute``: delivered rows also run the expert
    up-projections in the wire's integer dtype (int8 x int8 -> i32)."""

    name: str
    wire_dtype: str               # torch / jnp dtype name of the payload
    scaled: bool = False
    quantize_compute: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.wire_dtype)

    @property
    def wire_bytes_per_elem(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def encode(self, x, *, block_ndim: int = 2):
        """[..., *block] -> (payload, scale | None); ``block_ndim``
        trailing dims form one scale block and the f32 scale drops them."""
        raise NotImplementedError

    def decode(self, payload, scale, out_dtype):
        """Inverse of :meth:`encode`; ``scale`` already broadcast to the
        payload's shape (None for cast codecs)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class CastCodec(WireCodec):
    """Scale-free cast around the wire."""

    def encode(self, x, *, block_ndim: int = 2):
        return x.to(self.dtype), None

    def decode(self, payload, scale, out_dtype):
        return payload.to(out_dtype)


@dataclasses.dataclass(frozen=True)
class ScaledCodec(WireCodec):
    """Symmetric per-block absmax scaling into a narrow wire dtype.
    ``qmax`` is the dtype's largest magnitude used (127 for int8, 448 for
    float8_e4m3fn).  All-zero blocks get scale 1, so zero-filled slack
    rows come back exact.  Integer wires round half to even (as
    ``jnp.round``) and clip to ``±qmax``."""

    scaled: bool = True
    qmax: float = 127.0

    def encode(self, x, *, block_ndim: int = 2):
        dims = tuple(range(x.dim() - block_ndim, x.dim()))
        xf = x.to(torch.float32)
        absmax = xf.abs().amax(dim=dims)
        scale = torch.where(absmax > 0, absmax,
                            torch.full_like(absmax, self.qmax)) / self.qmax
        q = xf / scale.reshape(scale.shape + (1,) * block_ndim)
        if not self.dtype.is_floating_point:
            q = torch.clamp(torch.round(q), -self.qmax, self.qmax)
        return q.to(self.dtype), scale

    def decode(self, payload, scale, out_dtype):
        return (payload.to(torch.float32) * scale).to(out_dtype)


CODECS = {
    "bf16": CastCodec(name="bf16", wire_dtype="bfloat16"),
    "int8": ScaledCodec(name="int8", wire_dtype="int8", qmax=127.0,
                        quantize_compute=True),
    "fp8e4m3": ScaledCodec(name="fp8e4m3", wire_dtype="float8_e4m3fn",
                           qmax=448.0),
}


def get_codec(spec) -> WireCodec | None:
    """None / "" -> None (the raw model-dtype wire), a codec -> itself, a
    registered name -> the codec; anything else raises naming the
    registry."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, WireCodec):
        return spec
    codec = CODECS.get(spec)
    if codec is None:
        raise ValueError(
            f"unknown wire codec {spec!r}; registered codecs: "
            f"{sorted(CODECS)} (or pass a WireCodec instance)")
    return codec

"""Serving engine: fused prefill, decode steps, and continuous batching
(the counterpart of ``repro/serving/engine.py``).

- ``make_prefill`` / ``make_decode_step`` — single-call entries over
  ``models/decode.py``.
- ``generate`` — single-batch generation: one fused prefill, then one
  decode step per generated token.
- ``ServingEngine`` — slot-based continuous batching: a ``Scheduler``
  admits requests into a fixed pool of decode slots, admission packs are
  prefilled together and inserted into a ``SlotKVCache``, and every
  decode step advances all slots at once.

PyTorch runs eagerly, so there is no jit counterpart.  Sampling is
greedy (``argmax``) at temperature 0 and categorical otherwise, drawn
from a ``torch.Generator`` seeded per run (other numbers than the
reference's PRNG key gives).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import decode as decode_lib
from repro_torch.models import transformer
from repro_torch.serving import batching
from repro_torch.serving.scheduler import Request, Scheduler


def make_decode_step(ctx: transformer.ModelCtx):
    """``step(params, cache, tokens [B, 1]) -> (logits [B, 1, V], cache)``;
    the cache is updated in place."""

    @torch.no_grad()
    def step(params, cache, tokens):
        return decode_lib.decode_step(params, cache, tokens, ctx)
    return step


def _with_overrides(ctx: transformer.ModelCtx, dispatch_override):
    """Serving-side per-layer dispatch override: entries merge per layer
    index with the ctx's own, the serving side winning; a pipelined
    override gets the overlap model's chunk count and a chunk-aligned plan
    when the ctx has none."""
    if dispatch_override is None:
        return ctx
    from repro_torch.core import capacity
    from repro_torch.core.dispatch import engine as dispatch_lib
    from repro_torch.models import model as model_lib
    for _, name in dispatch_override:
        dispatch_lib.check_name(name)
    merged = dict(ctx.dispatch_override)
    merged.update(dict(dispatch_override))
    ctx = dataclasses.replace(ctx,
                              dispatch_override=tuple(sorted(merged.items())))
    if (ctx.plan is not None and ctx.a2a_num_chunks <= 1
            and any(n == "a2a_pipelined" for _, n in ctx.dispatch_override)):
        nc = model_lib.resolve_num_chunks(ctx.arch, ctx.plan, 0)
        ctx = dataclasses.replace(
            ctx, a2a_num_chunks=nc,
            plan=capacity.align_to_chunks(ctx.plan, nc))
    return ctx


def make_prefill(ctx: transformer.ModelCtx, dispatch_override=None, *,
                 with_cache: bool = False, cache_len: int | None = None):
    """Fused full-sequence prefill.

    Default (``with_cache=False``): ``prefill(params, batch) ->
    last_logits [B, V]`` through ``transformer.forward`` (the training
    dispatch path of each layer).  ``with_cache=True`` (requires
    ``cache_len``): ``prefill(params, batch) -> (last_logits [B, V],
    cache)`` where ``batch`` is ``{"tokens": [B, S], optional "lens":
    [B]}``.  ``dispatch_override`` (``((layer, path), ...)``) merges into
    the ctx's per-layer overrides."""
    ctx = _with_overrides(ctx, dispatch_override)
    if with_cache:
        if cache_len is None:
            raise ValueError("with_cache=True requires cache_len")

        @torch.no_grad()
        def prefill_cached(params, batch):
            return decode_lib.prefill(params, batch, ctx,
                                      cache_len=cache_len,
                                      lens=batch.get("lens"))
        return prefill_cached

    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = transformer.forward(params, batch, ctx)
        return logits[:, -1]
    return prefill


def sample(logits, temps, generator=None):
    """Per-row sampler: greedy where temperature <= 0, categorical at
    ``logits / temperature`` elsewhere.  logits [N, V], temps [N]."""
    lf = logits.to(torch.float32)
    greedy = torch.argmax(lf, dim=-1)
    if not bool((temps > 0).any()):
        return greedy.to(torch.int32)
    scaled = lf / torch.clamp(temps, min=1e-6)[:, None]
    drawn = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                              generator=generator)[:, 0]
    return torch.where(temps > 0, drawn, greedy).to(torch.int32)


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor         # [B, steps]
    steps_per_sec: float


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, ctx: transformer.ModelCtx, prompt_tokens, *,
             steps: int, cache_len: int, temperature: float = 0.0,
             seed: int = 0, lens=None) -> GenerationResult:
    """Greedy/temperature generation: one fused prefill, then ``steps - 1``
    decode steps; ``steps_per_sec`` counts generated tokens only."""
    B, S = prompt_tokens.shape
    dev = prompt_tokens.device
    prefill_fn = make_prefill(ctx, with_cache=True, cache_len=cache_len)
    step_fn = make_decode_step(ctx)
    temps = torch.full((B,), temperature, dtype=torch.float32, device=dev)
    batch = {"tokens": prompt_tokens,
             "lens": (torch.as_tensor(lens, device=dev).to(torch.int32)
                      if lens is not None
                      else torch.full((B,), S, dtype=torch.int32,
                                      device=dev))}
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.time()
    logits, cache = prefill_fn(params, batch)
    tok = sample(logits, temps, gen)[:, None]
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = step_fn(params, cache, tok)
        tok = sample(logits[:, 0], temps, gen)[:, None]
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    _sync(dev)
    dt = time.time() - t0
    return GenerationResult(tokens=tokens,
                            steps_per_sec=steps / max(dt, 1e-9))


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static shapes of the continuous-batching engine: ``num_slots``
    decode slots run every step; admission packs are ``prefill_pack``
    wide with prompts right-padded to the smallest ``prompt_buckets``
    entry that fits.  Every request must satisfy
    ``prompt_len + max_new_tokens <= cache_len``."""
    num_slots: int = 8
    cache_len: int = 128
    prefill_pack: int = 4
    prompt_buckets: tuple = (32,)


@dataclasses.dataclass
class ServingReport:
    streams: list                  # finished Stream records, completion order
    wall_time: float
    total_new_tokens: int
    decode_steps: int
    prefill_calls: int
    evictions: int = 0             # deadline-evicted streams

    @property
    def tokens_per_sec(self) -> float:
        return self.total_new_tokens / max(self.wall_time, 1e-9)

    def tokens_for(self, uid: int):
        for s in self.streams:
            if s.request.uid == uid:
                return s.generated
        raise KeyError(uid)


class ServingEngine:
    """Slot-based continuous batching over the MoE decode path.  Per loop
    iteration: (1) admit pending requests into free slots and prefill them
    as one pack, (2) advance every slot one decode step, (3) complete
    streams that hit their budget, freeing their slots."""

    def __init__(self, params, ctx: transformer.ModelCtx, cfg: ServeConfig):
        self.params = params
        self.ctx = ctx
        self.cfg = cfg
        if max(cfg.prompt_buckets) > cfg.cache_len:
            raise ValueError("prompt bucket exceeds cache_len")
        self.device = torch.device(self.ctx.device)
        self._prefill = make_prefill(self.ctx, with_cache=True,
                                     cache_len=cfg.cache_len)
        self._decode = make_decode_step(self.ctx)

    def _admit(self, sched, kv, cur, temps, gen, now):
        cfg = self.cfg
        admits = sched.take(cfg.prefill_pack, now=now)
        if not admits:
            return 0
        for _, req in admits:
            if req.frontend is not None:
                raise NotImplementedError(f"request {req.uid}: modality "
                                          f"frontends are not ported yet")
            need = req.prompt_len + req.max_new_tokens
            if need > cfg.cache_len:
                raise ValueError(
                    f"request {req.uid}: prompt+new tokens {need} exceed "
                    f"cache_len {cfg.cache_len}")
        tokens, lens = batching.pad_pack([req.tokens for _, req in admits],
                                         cfg.prefill_pack,
                                         cfg.prompt_buckets,
                                         device=self.device)
        logits, pack_cache = self._prefill(self.params,
                                           {"tokens": tokens, "lens": lens})
        slots = np.full((cfg.prefill_pack,), cfg.num_slots, np.int64)
        slots[:len(admits)] = [s for s, _ in admits]
        kv.insert(pack_cache, slots)
        pack_temps = np.zeros((cfg.prefill_pack,), np.float32)
        for i, (s, req) in enumerate(admits):
            temps[s] = req.temperature
            pack_temps[i] = req.temperature
        first = sample(logits, torch.as_tensor(pack_temps,
                                               device=self.device), gen)
        # padded pack rows (slot id num_slots) are dropped, as the
        # reference's out-of-bounds scatter drops them
        n = len(admits)
        cur[torch.as_tensor(slots[:n], device=self.device), 0] = first[:n]
        first_host = first.cpu().numpy()
        for i, (s, _) in enumerate(admits):
            if sched.on_token(s, int(first_host[i])):
                sched.complete(s, now=time.time())
        return 1

    @torch.no_grad()
    def run(self, requests, *, seed: int = 0) -> ServingReport:
        """Serve ``requests`` to completion; returns per-stream stats."""
        cfg = self.cfg
        sched = Scheduler(cfg.num_slots)
        for req in requests:
            sched.submit(req)
        kv = batching.SlotKVCache(self.ctx, cfg.num_slots, cfg.cache_len)
        cur = torch.zeros((cfg.num_slots, 1), dtype=torch.int32,
                          device=self.device)
        temps = np.zeros((cfg.num_slots,), np.float32)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        decode_steps = prefill_calls = evictions = 0
        t0 = time.time()
        while sched.has_work:
            prefill_calls += self._admit(sched, kv, cur, temps, gen,
                                         now=time.time())
            now = time.time()
            overdue = sched.expired(now)
            if overdue:
                kv.evict(overdue)
                for slot in overdue:
                    sched.evict(slot, now=now)
                evictions += len(overdue)
            if not sched.num_active:
                continue        # everything admitted finished at 1 token
            logits, kv.cache = self._decode(self.params, kv.cache, cur)
            nxt = sample(logits[:, 0], torch.as_tensor(temps,
                                                       device=self.device),
                         gen)
            cur = nxt[:, None].contiguous()
            decode_steps += 1
            nxt_host = nxt.cpu().numpy()
            for slot in sched.active_slots():
                if sched.on_token(slot, int(nxt_host[slot])):
                    sched.complete(slot, now=time.time())
        _sync(self.device)
        wall = time.time() - t0
        total = sum(len(s.generated) for s in sched.finished)
        return ServingReport(streams=sched.finished, wall_time=wall,
                             total_new_tokens=total,
                             decode_steps=decode_steps,
                             prefill_calls=prefill_calls,
                             evictions=evictions)


__all__ = ["GenerationResult", "Request", "ServeConfig", "ServingEngine",
           "ServingReport", "generate", "make_decode_step", "make_prefill",
           "sample"]

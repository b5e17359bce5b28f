"""Serving engine: fused prefill, decode steps, and continuous batching
(the counterpart of ``repro/serving/engine.py``).

- ``make_prefill`` / ``make_decode_step`` — single-call entries over
  ``models/decode.py``.
- ``generate`` — single-batch generation: one fused prefill, then one
  decode step per generated token; ``make_generate_fns`` builds the
  (prefill, decode step, sampler) triple it runs, to pass as ``fns=``
  across many calls.
- ``ServingEngine`` — slot-based continuous batching: a ``Scheduler``
  admits requests into a fixed pool of decode slots, admission packs are
  prefilled together and inserted into a ``SlotKVCache``, and every
  decode step advances all slots at once.

PyTorch runs eagerly, so there is no jit counterpart.  Sampling is
greedy (``argmax``) at temperature 0 and categorical otherwise, drawn
from a ``torch.Generator`` seeded per run (other numbers than the
reference's PRNG key gives).

On an EP world (``ctx.mesh`` of ``n`` ranks) the batch is sharded over
the world, as the reference's ``x_spec`` shards it over the hierarchy
axes: each rank holds ``num_slots / n`` decode slots (rank ``r`` the
slots ``r * num_slots / n`` on) and prefills ``prefill_pack / n`` rows of
each pack; its MoE layers reach the other ranks' experts through the
gather path.  The last-position logits are all-gathered over the world
and every rank samples the whole batch with the same generator, so
every rank's scheduler takes the same decisions.  A prefilled pack's
cache rows are all-gathered too, and each rank keeps those of its slots.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.launch.mesh import gather_rows
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
    [B], optional "frontend": [B, F, width]}``.  ``dispatch_override`` (``((layer, path), ...)``) merges into
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


def _batch_shard(ctx: transformer.ModelCtx, **counts) -> tuple:
    """``(rank, ranks)`` of the world the batch is sharded over (``(0,
    1)`` without one); ValueError naming each count in ``counts`` that
    does not divide over the ranks."""
    world = ctx.mesh
    if world is None or world.size == 1:
        return 0, 1
    for name, n in counts.items():
        if n % world.size:
            raise ValueError(f"{name} {n} does not divide over the world's "
                             f"{world.size} ranks")
    return world.rank, world.size


def make_generate_fns(ctx: transformer.ModelCtx, cache_len: int):
    """The ``(prefill, decode_step, sample)`` triple :func:`generate`
    runs: the cached prefill at ``cache_len``, the decode step and
    :func:`sample`.  Build it once and pass it as ``generate(...,
    fns=...)`` across many calls (the reference's builds its jitted
    closures once so; here it saves rebuilding the closures)."""
    return (make_prefill(ctx, with_cache=True, cache_len=cache_len),
            make_decode_step(ctx), sample)


def generate(params, ctx: transformer.ModelCtx, prompt_tokens, *,
             steps: int, cache_len: int, temperature: float = 0.0,
             seed: int = 0, frontend=None, lens=None,
             fns=None) -> GenerationResult:
    """Greedy/temperature generation: one fused prefill, then ``steps - 1``
    decode steps; ``steps_per_sec`` counts generated tokens only.
    ``frontend`` [B, F, width] is the batch's frontend embeddings (audio
    frames, vision patches).  ``fns``: a :func:`make_generate_fns` triple
    (built here when None).  On a world every rank passes the whole
    batch, computes its rows and returns the whole batch's tokens."""
    B, S = prompt_tokens.shape
    dev = prompt_tokens.device
    rank, n = _batch_shard(ctx, batch=B)
    rows = slice(rank * B // n, (rank + 1) * B // n)
    prefill_fn, step_fn, sample_fn = (
        fns if fns is not None else make_generate_fns(ctx, cache_len))
    temps = torch.full((B,), temperature, dtype=torch.float32, device=dev)
    lens = (torch.as_tensor(lens, device=dev).to(torch.int32)
            if lens is not None
            else torch.full((B,), S, dtype=torch.int32, device=dev))
    batch = {"tokens": prompt_tokens[rows], "lens": lens[rows]}
    if frontend is not None:
        batch["frontend"] = torch.as_tensor(frontend, device=dev)[rows]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.time()
    logits, cache = prefill_fn(params, batch)
    tok = sample_fn(gather_rows(ctx.mesh, logits), temps, gen)[:, None]
    out = [tok]
    for _ in range(steps - 1):
        logits, cache = step_fn(params, cache, tok[rows])
        tok = sample_fn(gather_rows(ctx.mesh, logits[:, 0]), temps,
                        gen)[:, None]
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
    streams that hit their budget, freeing their slots.  On a world,
    ``num_slots`` and ``prefill_pack`` must divide over its ranks."""

    def __init__(self, params, ctx: transformer.ModelCtx, cfg: ServeConfig):
        self.params = params
        self.ctx = ctx
        self.cfg = cfg
        if max(cfg.prompt_buckets) > cfg.cache_len:
            raise ValueError("prompt bucket exceeds cache_len")
        rank, n = _batch_shard(ctx, num_slots=cfg.num_slots,
                               prefill_pack=cfg.prefill_pack)
        self._slots = cfg.num_slots // n          # this rank's slots
        self._first_slot = rank * self._slots
        self._pack_rows = slice(rank * cfg.prefill_pack // n,
                                (rank + 1) * cfg.prefill_pack // n)
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
            need = req.prompt_len + req.max_new_tokens
            if need > cfg.cache_len:
                raise ValueError(
                    f"request {req.uid}: prompt+new tokens {need} exceed "
                    f"cache_len {cfg.cache_len}")
        tokens, lens = batching.pad_pack([req.tokens for _, req in admits],
                                         cfg.prefill_pack,
                                         cfg.prompt_buckets,
                                         device=self.device)
        rows = self._pack_rows
        batch = {"tokens": tokens[rows], "lens": lens[rows]}
        if any(req.frontend is not None for _, req in admits):
            batch["frontend"] = batching.pad_frontend_pack(
                [req.frontend for _, req in admits], cfg.prefill_pack,
                self.device)[rows]
        logits, pack_cache = self._prefill(self.params, batch)
        logits = gather_rows(self.ctx.mesh, logits)
        pack_cache = decode_lib.gather_cache_rows(self.ctx.mesh, pack_cache,
                                                  tokens.shape[1])
        # this rank's slot ids; the other ranks' slots and the padded pack
        # rows (slot id num_slots) map past the local cache and are dropped,
        # as the reference's out-of-bounds scatter drops them
        slots = np.full((cfg.prefill_pack,), cfg.num_slots, np.int64)
        slots[:len(admits)] = [s for s, _ in admits]
        local = slots - self._first_slot
        local[(local < 0) | (local >= self._slots)] = self._slots
        kv.insert(pack_cache, local)
        pack_temps = np.zeros((cfg.prefill_pack,), np.float32)
        for i, (s, req) in enumerate(admits):
            temps[s] = req.temperature
            pack_temps[i] = req.temperature
        first = sample(logits, torch.as_tensor(pack_temps,
                                               device=self.device), gen)
        mine = np.nonzero(local < self._slots)[0]
        if len(mine):
            cur[torch.as_tensor(local[mine], device=self.device), 0] = \
                first[torch.as_tensor(mine, device=self.device)]
        first_host = first.cpu().numpy()
        for i, (s, _) in enumerate(admits):
            if sched.on_token(s, int(first_host[i])):
                sched.complete(s, now=time.time())
        return 1

    def _expired(self, sched, now: float) -> list:
        """The scheduler's overdue slots; on a world, a slot is overdue
        where any rank's clock finds it so (one all-reduce, only while a
        stream has a deadline), so every rank evicts the same streams."""
        overdue = sched.expired(now)
        world = self.ctx.mesh
        if world is None or world.size == 1 or not any(
                sched.stream(s).request.deadline_s is not None
                for s in sched.active_slots()):
            return overdue
        mask = torch.zeros((self.cfg.num_slots,), dtype=torch.float32)
        mask[overdue] = 1.0
        mask = world.all_reduce_sum(mask.to(self.device))
        return [int(s) for s in torch.nonzero(mask > 0).flatten().tolist()]

    @torch.no_grad()
    def run(self, requests, *, seed: int = 0) -> ServingReport:
        """Serve ``requests`` to completion; returns per-stream stats."""
        cfg = self.cfg
        sched = Scheduler(cfg.num_slots)
        for req in requests:
            sched.submit(req)
        kv = batching.SlotKVCache(self.ctx, self._slots, cfg.cache_len)
        cur = torch.zeros((self._slots, 1), dtype=torch.int32,
                          device=self.device)
        temps = np.zeros((cfg.num_slots,), np.float32)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        decode_steps = prefill_calls = evictions = 0
        t0 = time.time()
        while sched.has_work:
            prefill_calls += self._admit(sched, kv, cur, temps, gen,
                                         now=time.time())
            now = time.time()
            overdue = self._expired(sched, now)
            if overdue:
                kv.evict([s - self._first_slot for s in overdue
                          if 0 <= s - self._first_slot < self._slots])
                for slot in overdue:
                    sched.evict(slot, now=now)
                evictions += len(overdue)
            if not sched.num_active:
                continue        # everything admitted finished at 1 token
            logits, kv.cache = self._decode(self.params, kv.cache, cur)
            nxt = sample(gather_rows(self.ctx.mesh, logits[:, 0]),
                         torch.as_tensor(temps, device=self.device), gen)
            cur = nxt[self._first_slot:self._first_slot + self._slots,
                      None].contiguous()
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
           "ServingReport", "generate", "make_decode_step",
           "make_generate_fns", "make_prefill", "sample"]

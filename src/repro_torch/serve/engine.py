"""Batched serving engine: slot-based continuous batching (PyTorch port of
``repro/serve/engine.py``).

A fixed pool of B slots decodes in lockstep with ONE decode step per token,
using per-slot position vectors.  Requests join free slots mid-flight:
their prompt replays through the same decode step into that slot's cache
rows; finished slots (EOS / max_new / max_len) free at once.  The engine
defaults to the card (`make_engine()`); only the sampled token ids come
back to the host.

A program that holds a mamba layer (a mamba stack, or the hybrid) is
admitted differently: its slot's mamba rows (conv tails and state, of the
super entries and the tail alike) are zeroed, then all of its prompt but
the last token runs through the prefill (`models.transformer.
forward_prefill`, the chunked SSD scan: on `cuda` the SSD kernel, and the
hybrid's shared attention through the flash forward) into them and into
the slot's shared-block KV rows [0, L - 1), instead of one lockstep decode
step per token; the last prompt token then decodes with the other slots
and gives the first new token.  Without the prefill the SSD kernel would
never run on this path (a decode step is the recurrence).  A dense, GQA
MoE or MLA stack keeps the replay, so its streams stay those of the JAX
engine, which replays every prompt token through the decode program (an
MLA slot's latent rows are written by the absorbed decode step).

Implements the shared `ServingFrontend` protocol (serve/frontend.py) with
the same stats schema as the CNN engine.  Prompts longer than the KV cache
are rejected at `submit` with `frontend.RejectedRequest` (or truncated with
`req.truncated` set, under ``on_overflow="truncate"``); so is an empty
prompt, as the paged engine rejects it (the JAX slot engine accepts one
and decodes the slot's stale last token).  A vision config is served on
its text alone (no patch embeddings reach a decode step), as the JAX
engine serves it; an encoder-only config is refused at construction
(`serve_step.require_decoder`; JAX's engine takes it).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import ComputeEngine, backends, make_engine
from repro_torch.models.transformer import forward_prefill, stack_program
from repro_torch.serve import frontend as fe
from repro_torch.serve import kvcache
from repro_torch.serve.serve_step import (greedy_sample, make_decode_step,
                                          require_decoder)


@dataclasses.dataclass
class Request(fe.Request):
    """LM generation request; `out` accumulates generated token ids."""
    prompt: list[int] = dataclasses.field(default_factory=list)
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)


class ServingEngine(fe.ServingFrontend):
    def __init__(self, cfg, params, *, engine: ComputeEngine | None = None,
                 slots: int = 4, max_len: int = 128,
                 eos_id: int | None = None, on_overflow: str = "reject"):
        if on_overflow not in ("reject", "truncate"):
            raise ValueError(f"on_overflow must be 'reject' or 'truncate', "
                             f"got {on_overflow!r}")
        require_decoder(cfg, "ServingEngine")
        self.cfg, self.params = cfg, params
        self.slots, self.max_len, self.eos_id = slots, max_len, eos_id
        self.on_overflow = on_overflow
        self.engine = engine = engine or make_engine()
        self.caches = kvcache.cache_init(cfg, slots, max_len,
                                         engine.precision.compute_dtype,
                                         engine.device)
        self._decode = make_decode_step(engine, cfg)
        self._ssm = any(kind in ("mamba", "zamba_super")
                        for kind, _ in stack_program(cfg))
        self.pos = np.zeros(slots, np.int32)          # next write position
        self.active: list[Request | None] = [None] * slots
        self.pending: deque[Request] = deque()
        self._replay: list[deque] = [deque() for _ in range(slots)]
        self._last: np.ndarray = np.zeros(slots, np.int32)
        # Engine-op plan of one decode step, captured from the registry's
        # dispatch counters around the first call.
        self.op_counts: dict | None = None
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._truncated = 0
        self._steps = 0
        self._idle_steps = 0
        self._tokens = 0
        self._wall_s = 0.0
        self._latency = fe.LatencyAgg()

    def submit(self, req: Request):
        if not req.prompt:
            # A request starts from its prompt's last token; with none, the
            # first step would feed the slot's previous occupant's token
            # (the JAX slot engine does).  Refused as the paged engine does.
            self._rejected += 1
            raise fe.RejectedRequest("empty prompt")
        if len(req.prompt) > self.max_len:
            # A longer prompt would replay past the cache end: the write at
            # pos == max_len clamps onto the last row and corrupts it.
            if self.on_overflow == "reject":
                self._rejected += 1
                raise fe.RejectedRequest(
                    f"prompt length {len(req.prompt)} exceeds the KV cache "
                    f"(max_len={self.max_len}); shorten the prompt or build "
                    f"the engine with on_overflow='truncate'")
            # Keep the prompt TAIL (the most recent context), as much as
            # fits while still delivering the full max_new budget — a
            # prompt of L can generate max_len - L + 1 tokens (the first
            # comes from the last prefill step's logits).  When max_new
            # alone exceeds the cache, prompt retention wins and
            # generation caps at 1 token.
            keep = (self.max_len - req.max_new + 1
                    if req.max_new < self.max_len else self.max_len)
            req.prompt = req.prompt[-keep:]
            req.truncated = True
            self._truncated += 1
        req.t_submit = time.perf_counter()
        self.pending.append(req)
        self._submitted += 1

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.pending:
                req = self.pending.popleft()
                self.active[s] = req
                self.pos[s] = self._prefill(s, req.prompt)
                self._replay[s] = deque(req.prompt[self.pos[s]:])

    def _prefill(self, s: int, prompt: list) -> int:
        """Start slot `s` on `prompt`; returns how many prompt tokens that
        consumed.  A dense stack consumes none: its prompt replays through
        the lockstep decode step, and its stale cache rows lie past the new
        position, masked by it.  A program with mamba layers has its slot's
        mamba rows (conv tails and SSM state) zeroed, so the request does
        not start from the previous occupant's history (the JAX engine
        resets only the position, and there a reused slot carries the old
        state), and all of the prompt but its last token runs through the
        prefill (on `cuda` the SSD kernel) into them, and for the hybrid
        into the slot's shared-block KV rows [0, L - 1) (rows past them
        are masked by the position, as a dense slot's)."""
        if not self._ssm:
            return 0
        for rows in kvcache.slot_rows(self.cfg, self.caches, s):
            rows.zero_()
        n = len(prompt) - 1
        if n < 1:
            return 0
        toks = torch.tensor([prompt[:-1]], dtype=torch.int64,
                            device=self.engine.device)
        with torch.inference_mode():
            _, caches = forward_prefill(self.engine, self.cfg, self.params,
                                        tokens=toks)
            for dst, src in zip(
                    kvcache.slot_rows(self.cfg, self.caches, s, n),
                    kvcache.slot_rows(self.cfg, caches, 0, n)):
                dst.copy_(src)
        return n

    def step(self) -> int:
        """One lockstep decode across all slots (idle slots ride along)."""
        t0 = time.perf_counter()
        self._admit()
        n_active = sum(r is not None for r in self.active)
        if n_active == 0:
            # no dispatch when every slot is idle: count it and bail
            # before paying a full lockstep decode for nothing.
            self._idle_steps += 1
            return 0
        toks = np.zeros((self.slots, 1), np.int32)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            toks[s, 0] = (self._replay[s].popleft() if self._replay[s]
                          else self._last[s])
        snap = backends.dispatch_counts() if self.op_counts is None else None
        dev = self.engine.device
        with torch.inference_mode():
            logits, self.caches = self._decode(
                self.params, self.caches,
                torch.tensor(toks, dtype=torch.int64, device=dev),
                torch.tensor(self.pos, dtype=torch.int64, device=dev))
            # argmax on the device: only the (slots,) sampled token ids
            # come to the host, never the (slots, vocab) logits.
            nxt = greedy_sample(logits).cpu().numpy()
        if snap is not None:
            self.op_counts = backends.counts_since(snap)
        now = time.perf_counter()
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            self._last[s] = nxt[s]
            if self._replay[s]:
                continue  # still prefilling this slot
            req.out.append(int(nxt[s]))
            self._tokens += 1
            if (len(req.out) >= req.max_new
                    or (self.eos_id is not None
                        and req.out[-1] == self.eos_id)
                    or self.pos[s] >= self.max_len):
                req.done = True
                req.t_done = now
                self._latency.add(req.latency_s)
                self._completed += 1
                self.active[s] = None
        self._steps += 1
        self._wall_s += now - t0
        return n_active

    def stats(self) -> dict:
        return fe.build_stats(
            engine="lm", submitted=self._submitted,
            completed=self._completed, rejected=self._rejected,
            truncated=self._truncated, steps=self._steps,
            wall_s=self._wall_s, latency=self._latency,
            items=self._tokens,
            extra={"tokens": self._tokens, "slots": self.slots,
                   "max_len": self.max_len,
                   "idle_steps": self._idle_steps,
                   "op_counts": dict(self.op_counts or {})})

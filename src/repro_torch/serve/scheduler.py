"""Continuous-batching LM scheduler over the paged KV pool (PyTorch port of
``repro/serve/scheduler.py``).

The default LM serving frontend.  Where the slot engine (serve/engine.py)
reserves `max_len` KV rows per slot and decodes every slot in lockstep,
this scheduler admits against a shared block pool (serve/kvpool.py) and
runs the production loop each `step()`:

  1. ADMIT   FIFO from the pending queue while the pool can cover the head
             request's WORST-CASE block demand (prompt rounded up to chunk
             boundaries, plus its full decode budget), so an admitted
             sequence never fails an extend mid-flight.  A `max_wait_s`
             deadline bounds queueing: a head request that cannot fit in
             time expires (counted, left not-done).
  2. PREFILL chunked: each prefilling sequence advances up to `chunk`
             prompt tokens per dispatch (B = 1, causal attention
             right-aligned against its live kv_len); `prefill_budget`
             bounds the prompt tokens per step.
  3. DECODE  every decode-phase sequence advances one token, batched and
             padded to a batch bucket, with per-sequence positions.
  4. RETIRE  finished sequences (EOS / max_new / max_len) free their blocks
             at once.

Prefill and decode dispatch ONE step function, `make_paged_step`, through a
`StepCompileCache`: shapes are padded to (batch bucket, chunk, block
bucket) combinations, so the number of builds is bounded by the bucket-set
product however ragged the traffic (padded rows point their block tables
at the pool's trash block).  On the `cuda` backend a prefill chunk runs
the flash-attention kernel and a decode dispatch against 256 or more
gathered rows the split-KV decode kernel.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import (ComputeEngine, StepCompileCache, backends,
                              make_engine, normalize_buckets, pick_bucket)
from repro_torch.serve import frontend as fe
from repro_torch.serve import kvpool
from repro_torch.serve.engine import Request
from repro_torch.serve.serve_step import make_paged_step, require_decoder


@dataclasses.dataclass
class _Seq:
    """In-flight bookkeeping for one admitted request."""
    req: Request
    ws_blocks: int       # worst-case block reservation made at admission
    held: int = 0        # blocks currently claimed from the allocator
    kv_len: int = 0      # KV rows written so far (== tokens consumed)
    last: int = 0        # last generated token id (next decode input)

    @property
    def prefilling(self) -> bool:
        return self.kv_len < len(self.req.prompt)


class PagedServingEngine(fe.ServingFrontend):
    """Continuous-batching LM frontend over a paged KV pool.

    Same `ServingFrontend` protocol and stats schema as the slot engine;
    `kv_blocks * block_size` total KV rows replace `slots * max_len`.
    Greedy decoding, like the slot engine.  Defaults to the card
    (`make_engine()`).  A vision config is served on its text alone; an
    encoder-only config is refused (`serve_step.require_decoder`).
    """

    def __init__(self, cfg, params, *, engine: ComputeEngine | None = None,
                 kv_blocks: int = 64, block_size: int = 16,
                 max_len: int = 128, eos_id: int | None = None,
                 chunk: int = 16, prefill_budget: int = 64,
                 batch_buckets=(1, 2, 4, 8), block_buckets=None,
                 max_wait_s: float | None = None):
        require_decoder(cfg, "PagedServingEngine")
        self.cfg, self.params = cfg, params
        self.engine = engine = engine or make_engine()
        self.max_len, self.eos_id = max_len, eos_id
        self.chunk = chunk
        self.prefill_budget = prefill_budget
        self.max_wait_s = max_wait_s
        self.alloc = kvpool.BlockAllocator(kv_blocks, block_size)
        self.cache = kvpool.PagedKVCache(cfg, kv_blocks, block_size,
                                         engine.precision.compute_dtype,
                                         engine.device)
        self.pools = self.cache.pools
        self.batch_buckets = normalize_buckets(batch_buckets)
        if block_buckets is None:
            # powers of two up to the largest table any sequence can need:
            # prefill touches whole chunks, so the top extent is max_len
            # rounded up to a chunk boundary.
            nb_max = self.alloc.blocks_for(self._chunk_ceil(max_len))
            block_buckets, b = [], 1
            while b < nb_max:
                block_buckets.append(b)
                b *= 2
            block_buckets.append(nb_max)
        self.block_buckets = normalize_buckets(block_buckets)
        self._step_fn = StepCompileCache(make_paged_step(engine, cfg),
                                         name="paged_step")
        self.active: dict[int, _Seq] = {}      # rid -> _Seq, FIFO order
        self.pending: deque[Request] = deque()
        self._outstanding = 0   # Σ (ws_blocks - held) over active seqs
        self.op_counts: dict | None = None
        self.peak_active = 0
        self._submitted = 0
        self._completed = 0
        self._rejected = 0
        self._expired = 0
        self._steps = 0
        self._idle_steps = 0
        self._tokens = 0
        self._wall_s = 0.0
        self._latency = fe.LatencyAgg()

    # ---------------------------------------------------------- admission

    def _chunk_ceil(self, n: int) -> int:
        return -(-n // self.chunk) * self.chunk

    def _worst_tokens(self, req: Request) -> int:
        """KV rows this request can ever occupy: prefill writes whole
        chunks ([0, ceil(prompt/chunk)*chunk)); decode writes one row per
        generated token after the first (which comes from the last prefill
        chunk's logits)."""
        return max(self._chunk_ceil(len(req.prompt)),
                   len(req.prompt) + max(1, req.max_new) - 1)

    def submit(self, req: Request) -> None:
        if not req.prompt:
            self._rejected += 1
            raise fe.RejectedRequest("empty prompt")
        if len(req.prompt) > self.max_len:
            self._rejected += 1
            raise fe.RejectedRequest(
                f"prompt length {len(req.prompt)} exceeds max_len="
                f"{self.max_len}")
        ws = self.alloc.blocks_for(self._worst_tokens(req))
        if ws > self.alloc.n_blocks:
            self._rejected += 1
            raise kvpool.PoolExhausted(
                f"request needs {ws} blocks worst-case, pool only has "
                f"{self.alloc.n_blocks}: raise kv_blocks or lower max_new")
        req.t_submit = time.perf_counter()
        self.pending.append(req)
        self._submitted += 1

    def _admit(self, now: float) -> None:
        while self.pending:
            head = self.pending[0]
            ws = self.alloc.blocks_for(self._worst_tokens(head))
            if ws <= self.alloc.free_blocks - self._outstanding:
                self.pending.popleft()
                seq = _Seq(req=head, ws_blocks=ws)
                # claim the first chunk's extent now; the rest stays a
                # reservation (outstanding) drawn down by later extends.
                self.alloc.alloc(head.rid, self.chunk)
                seq.held = self.alloc.blocks_for(self.chunk)
                self._outstanding += ws - seq.held
                self.active[head.rid] = seq
            elif (self.max_wait_s is not None
                  and now - head.t_submit > self.max_wait_s):
                self.pending.popleft()   # deadline expired: drop, keep FIFO
                self._expired += 1
                self._rejected += 1
            else:
                break  # head blocked within deadline: preserve FIFO order
        self.peak_active = max(self.peak_active, len(self.active))

    def _grow(self, seq: _Seq, n_tokens: int) -> None:
        """Extend a sequence's table to cover n_tokens rows, drawing the
        new blocks out of its admission-time reservation."""
        new = self.alloc.extend(seq.req.rid, n_tokens)
        seq.held += len(new)
        self._outstanding -= len(new)

    def _retire(self, seq: _Seq, now: float) -> None:
        req = seq.req
        req.done = True
        req.t_done = now
        self._latency.add(req.latency_s)
        self._completed += 1
        self._outstanding -= seq.ws_blocks - seq.held
        self.alloc.free(req.rid)
        del self.active[req.rid]

    # ----------------------------------------------------------- dispatch

    def _dispatch(self, tokens: np.ndarray, tables: np.ndarray,
                  pos: np.ndarray) -> np.ndarray:
        """One bucketed call through the step cache; returns the (B, C)
        greedy token ids.  The argmax runs on the device, so only the
        sampled tokens come to the host, never the (B, C, vocab) logits."""
        snap = backends.dispatch_counts() if self.op_counts is None else None
        with torch.inference_mode():
            logits, self.pools = self._step_fn(self.params, self.pools,
                                               tables, tokens, pos)
            toks = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if snap is not None:
            self.op_counts = backends.counts_since(snap)
        self._step_fn.record((tokens.shape[0], tokens.shape[1],
                              tables.shape[1]))
        return toks

    def _padded_tables(self, seqs: list[_Seq], n_rows: int) -> np.ndarray:
        nb = pick_bucket(max(len(self.alloc.table(s.req.rid))
                             for s in seqs), self.block_buckets)
        trash = self.cache.trash_block
        tables = np.full((n_rows, nb), trash, np.int32)
        for i, s in enumerate(seqs):
            t = self.alloc.table(s.req.rid)
            tables[i, :len(t)] = t
        return tables

    def _finish_token(self, seq: _Seq, tok: int, now: float) -> None:
        """Append one generated token and retire the sequence if done."""
        seq.req.out.append(tok)
        seq.last = tok
        self._tokens += 1
        if (len(seq.req.out) >= max(1, seq.req.max_new)
                or (self.eos_id is not None and tok == self.eos_id)
                or seq.kv_len >= self.max_len):
            self._retire(seq, now)

    def _prefill(self, worked: set) -> None:
        """Advance prefilling sequences, up to prefill_budget prompt
        tokens.  Budget gates whole chunks (never splits one), so chunk
        starts stay aligned to chunk boundaries."""
        budget = self.prefill_budget
        for seq in [s for s in self.active.values() if s.prefilling]:
            if budget <= 0:
                break
            prompt = seq.req.prompt
            c = min(self.chunk, len(prompt) - seq.kv_len)
            self._grow(seq, seq.kv_len + self.chunk)
            tokens = np.zeros((1, self.chunk), np.int32)
            tokens[0, :c] = prompt[seq.kv_len:seq.kv_len + c]
            tables = self._padded_tables([seq], 1)
            toks_out = self._dispatch(tokens, tables,
                                      np.asarray([seq.kv_len], np.int32))
            seq.kv_len += c
            budget -= c
            worked.add(seq.req.rid)
            if not seq.prefilling:   # last chunk's logits hold token #1
                self._finish_token(seq, int(toks_out[0, c - 1]),
                                   time.perf_counter())

    def _decode(self, worked: set) -> None:
        """One token for every decode-phase sequence, in bucketed groups."""
        decoding = [s for s in self.active.values() if not s.prefilling]
        top = self.batch_buckets[-1]
        for i in range(0, len(decoding), top):
            group = decoding[i:i + top]
            for s in group:
                self._grow(s, s.kv_len + 1)
            bb = pick_bucket(len(group), self.batch_buckets)
            tokens = np.zeros((bb, 1), np.int32)
            pos = np.zeros(bb, np.int32)
            for j, s in enumerate(group):
                tokens[j, 0] = s.last
                pos[j] = s.kv_len
            tables = self._padded_tables(group, bb)
            toks_out = self._dispatch(tokens, tables, pos)
            now = time.perf_counter()
            for j, s in enumerate(group):
                s.kv_len += 1
                worked.add(s.req.rid)
                self._finish_token(s, int(toks_out[j, 0]), now)

    # --------------------------------------------------------------- step

    def step(self) -> int:
        """One scheduler round: admit, prefill (budgeted), decode, retire.
        Returns the number of distinct requests advanced."""
        t0 = time.perf_counter()
        self._admit(t0)
        if not self.active:
            self._idle_steps += 1
            return 0
        worked: set = set()
        self._prefill(worked)
        self._decode(worked)
        self._steps += 1
        self._wall_s += time.perf_counter() - t0
        return len(worked)

    @property
    def trace_bound(self) -> int:
        """Upper bound on step builds: prefill shapes (1, chunk) plus decode
        shapes (bucket, 1), each times the block-bucket set."""
        return (1 + len(self.batch_buckets)) * len(self.block_buckets)

    def stats(self) -> dict:
        return fe.build_stats(
            engine="lm-paged", submitted=self._submitted,
            completed=self._completed, rejected=self._rejected,
            truncated=0, steps=self._steps, wall_s=self._wall_s,
            latency=self._latency, items=self._tokens,
            extra={"tokens": self._tokens, "max_len": self.max_len,
                   "chunk": self.chunk,
                   "prefill_budget": self.prefill_budget,
                   "pool": self.alloc.stats(),
                   "peak_active": self.peak_active,
                   "idle_steps": self._idle_steps,
                   "expired": self._expired,
                   "compile": self._step_fn.stats(),
                   "trace_bound": self.trace_bound,
                   "buckets": {"batch": self.batch_buckets,
                               "block": self.block_buckets,
                               "chunk": (self.chunk,)},
                   "op_counts": dict(self.op_counts or {})})

"""Paged KV-cache pool: block allocator, physical storage, gather and
scatter (PyTorch port of ``repro/serve/kvpool.py``).

One physical pool of fixed-size blocks shared by every in-flight sequence,
in place of the slot engine's `max_len` rows per slot.

  * `BlockAllocator`: host-side bookkeeping (alloc / extend / free, block
    tables, occupancy and fragmentation, a typed `PoolExhausted`
    admission signal).  The same code as the JAX package's.
  * `PagedKVCache`: the device tensors, per layer-program entry a pool
    (n_layers, n_blocks + 1, block_size, KV, hd).  Block `n_blocks` is the
    TRASH block: padded batch rows point their tables at it, so their
    writes land somewhere nothing reads.
  * `gather_block_cache` / `scatter_chunk`: gather a batch's blocks into
    the compact (n_layers, B, NB*bs, KV, hd) cache view `decode_hidden`
    runs on, and write only the newly written rows back.  The gather
    materialises the view on every dispatch, as the JAX design does; a
    kernel that reads block tables directly is later work.

Dense GQA stacks only: `PagedKVCache` refuses other programs.
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import stack_program
from repro_torch.serve import frontend as fe


class PoolExhausted(fe.RejectedRequest):
    """The pool cannot (or can never) cover a request's worst-case block
    demand.  Subclasses `RejectedRequest` so `ServingFrontend.run` counts
    it as an admission failure instead of crashing the batch."""


class BlockAllocator:
    """Host-side block bookkeeping for one physical pool.

    Sequences are identified by any hashable id.  `alloc` claims the
    blocks covering an initial token extent, `extend` grows a sequence to
    a new total extent, `free` returns every block to the pool.  Blocks
    are handed out LIFO from a free stack, so allocation order is
    deterministic and recently freed (cache-warm) blocks are reused first.

    `tokens` tracks the extent each sequence DECLARED, which is what the
    fragmentation stat measures against: a sequence holding 3 blocks for
    33 declared tokens wastes 15 slots at block_size=16.
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(f"need n_blocks >= 1 and block_size >= 1, got "
                             f"{n_blocks}, {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks - 1, -1, -1))  # pop() yields 0,1,..
        self._tables: dict = {}
        self._tokens: dict = {}
        self.peak_used = 0

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to cover n_tokens rows (ceil division)."""
        return -(-max(0, n_tokens) // self.block_size)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def live_tokens(self) -> int:
        return sum(self._tokens.values())

    def holds(self, seq_id) -> bool:
        return seq_id in self._tables

    def table(self, seq_id) -> tuple[int, ...]:
        return tuple(self._tables[seq_id])

    def tokens(self, seq_id) -> int:
        return self._tokens[seq_id]

    def alloc(self, seq_id, n_tokens: int) -> tuple[int, ...]:
        """Claim the blocks covering n_tokens for a NEW sequence."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if n_tokens < 1:
            raise ValueError(f"need n_tokens >= 1, got {n_tokens}")
        need = self.blocks_for(n_tokens)
        if need > len(self._free):
            raise PoolExhausted(
                f"sequence {seq_id!r} needs {need} blocks, pool has "
                f"{len(self._free)} free of {self.n_blocks}")
        self._tables[seq_id] = [self._free.pop() for _ in range(need)]
        self._tokens[seq_id] = n_tokens
        self.peak_used = max(self.peak_used, self.used_blocks)
        return tuple(self._tables[seq_id])

    def extend(self, seq_id, n_tokens: int) -> tuple[int, ...]:
        """Grow a sequence to n_tokens TOTAL extent; returns the newly
        claimed blocks (possibly empty).  Shrinking is not supported: a
        smaller n_tokens is a no-op."""
        if seq_id not in self._tables:
            raise KeyError(f"unknown sequence {seq_id!r}")
        table = self._tables[seq_id]
        need = self.blocks_for(n_tokens) - len(table)
        if need > len(self._free):
            raise PoolExhausted(
                f"extending sequence {seq_id!r} to {n_tokens} tokens needs "
                f"{need} more blocks, pool has {len(self._free)} free")
        new = [self._free.pop() for _ in range(max(0, need))]
        table.extend(new)
        self._tokens[seq_id] = max(self._tokens[seq_id], n_tokens)
        self.peak_used = max(self.peak_used, self.used_blocks)
        return tuple(new)

    def free(self, seq_id) -> int:
        """Return every block of a sequence to the pool; returns the count.
        Raises KeyError on an unknown id — a double-free is a bookkeeping
        bug upstream and must not be absorbed silently."""
        if seq_id not in self._tables:
            raise KeyError(f"unknown sequence {seq_id!r} (double free?)")
        blocks = self._tables.pop(seq_id)
        del self._tokens[seq_id]
        self._free.extend(blocks)
        return len(blocks)

    @property
    def occupancy(self) -> float:
        """Fraction of pool blocks currently claimed."""
        return self.used_blocks / self.n_blocks

    @property
    def fragmentation(self) -> float:
        """Fraction of claimed-block token slots not covered by declared
        extents (internal fragmentation of the last block per sequence)."""
        cap = self.used_blocks * self.block_size
        return (cap - self.live_tokens) / cap if cap else 0.0

    def stats(self) -> dict:
        return {"n_blocks": self.n_blocks, "block_size": self.block_size,
                "used_blocks": self.used_blocks,
                "free_blocks": self.free_blocks,
                "peak_used": self.peak_used,
                "sequences": len(self._tables),
                "live_tokens": self.live_tokens,
                "occupancy": self.occupancy,
                "fragmentation": self.fragmentation}


class PagedKVCache:
    """Physical paged KV storage for an all-dense GQA stack: one pool per
    layer-program entry, (n_layers, n_blocks + 1, block_size, KV, hd), the
    dense cache layout with the sequence axis factored into (block,
    offset).  Block index `n_blocks` is the trash block."""

    def __init__(self, cfg, n_blocks: int, block_size: int,
                 dtype=torch.float32, device=None):
        prog = stack_program(cfg)
        if any(kind != "dense" for kind, _ in prog):
            raise NotImplementedError(
                f"paged KV pools cover dense GQA stacks only, got "
                f"{[kind for kind, _ in prog]}")
        self.cfg = cfg
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.trash_block = n_blocks
        shape = (n_blocks + 1, block_size, cfg.n_kv_heads, cfg.head_dim)
        self.pools = [
            {"k": torch.zeros((n, *shape), dtype=dtype, device=device),
             "v": torch.zeros((n, *shape), dtype=dtype, device=device)}
            for _, n in prog]


def gather_block_cache(pools: list, block_tables: torch.Tensor) -> list:
    """Gather each sequence's blocks into the dense cache layout.

    pools: [{"k", "v": (n_layers, n_blocks + 1, bs, KV, hd)}];
    block_tables: (B, NB) int tensor on the pools' device, row b listing
    sequence b's blocks in order (padded rows and tails point at the trash
    block).  Returns [{"k", "v": (n_layers, B, NB*bs, KV, hd)}], fresh
    tensors; row validity is enforced downstream by per-sequence kv_len.
    """
    b, nb = block_tables.shape

    def g(p):
        n, _, bs, kvh, hd = p.shape
        return p[:, block_tables].reshape(n, b, nb * bs, kvh, hd)

    return [{k: g(v) for k, v in entry.items()} for entry in pools]


def scatter_chunk(pools: list, caches: list, block_tables: torch.Tensor,
                  pos: torch.Tensor, chunk: int) -> list:
    """Write rows [pos_b, pos_b + chunk) of each gathered cache back into the
    pools, IN PLACE (the JAX version returns updated copies); returns pools.

    caches: the gathered layout (n_layers, B, NB*bs, KV, hd) after the step
    wrote those rows.  pos: (B,) int tensor of write starts; padded rows
    carry pos 0 and an all-trash table.  The caller keeps pos + chunk
    within NB*bs (`serve_step.make_paged_step` checks it on the host); the
    rows are read with the JAX ``dynamic_slice`` clamp.  Real sequences
    touch disjoint (block, offset) pairs; only the trash block sees
    duplicate writes, where any one of them may win.
    """
    b, nb = block_tables.shape
    bs = pools[0]["k"].shape[2]
    dev = block_tables.device
    ar = torch.arange(chunk, device=dev)
    pos = pos.to(device=dev, dtype=torch.int64)
    tok = pos[:, None] + ar                                 # (B, C)
    blk = torch.gather(block_tables.to(torch.int64), 1, tok // bs).reshape(-1)
    off = (tok % bs).reshape(-1)
    start = torch.clamp(pos, 0, nb * bs - chunk)[:, None] + ar
    batch = torch.arange(b, device=dev)[:, None]
    for entry, cache in zip(pools, caches):
        for name, pool in entry.items():
            rows = cache[name][:, batch, start]             # (n, B, C, KV, hd)
            pool[:, blk, off] = rows.reshape(pool.shape[0], b * chunk,
                                             *pool.shape[3:])
    return pools

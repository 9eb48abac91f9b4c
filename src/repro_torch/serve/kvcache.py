"""Cache construction (PyTorch port of ``repro/serve/kvcache.py``).

Attention caches store the compact grouped layout (B, S, KV, hd), the
engine `attention` op's native KV layout, consumed by prefill and decode
with no H-broadcast.  SSM caches are O(1) in the sequence length: the last
conv - 1 rows of the x, B and C projections and the (H, P, N) state.  One
entry per layer-program entry, each layer's cache stacked under a leading
layer axis:
``[{"k", "v": (n_layers, B, S_max, KV, hd)}]`` for a dense stack,
``{"c_kv": (n_layers, B, S_max, kv_lora_rank), "k_rope": (n_layers, B,
S_max, qk_rope_dim)}`` for each MLA entry (the latent, not per-head K /
V),
``[{"conv_x": (n_layers, B, conv - 1, d_inner), "conv_B", "conv_C":
(n_layers, B, conv - 1, G * N), "ssm": (n_layers, B, H, P, N)}]`` for a
mamba stack, and for a hybrid super entry of n ``{"mamba": {the mamba
leaves, (n, attn_every, B, ...)}, "shared": {"k", "v": (n, B, S_max, KV,
hd)}}`` (JAX's ``cache_struct``), its tail's mamba entry after it.  The
dtype follows the engine's compute dtype (fp32 under fp32_strict, bf16
under mixed).  `cache_struct` writes the layout once, as tensors on the
``meta`` device (JAX's ``ShapeDtypeStruct`` tree); `cache_init` is its
zeros, and `slot_rows` and `copy_prefill` are the one place outside it
that reads this layout.  `cache_pspecs`, `cache_bytes` and
`kv_broadcast_bytes` are the dry run's accounting (launch/dryrun.py):
JAX's specs as tuples (`sharding/policy.py`'s convention), for a mesh
given as a ``DeviceMesh`` or a ``{dim: size}`` mapping.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.transformer import stack_program
from repro_torch.sharding.policy import mesh_sizes
from repro_torch.tree import flatten, unflatten_like

_META = torch.device("meta")


def _empty(*shape, dtype):
    return torch.empty(shape, dtype=dtype, device=_META)


def _entry_struct(kind: str, cfg, n: int, B: int, S: int, dtype,
                  inner: int = 0) -> dict:
    lead = (n, inner) if inner else (n,)
    if kind in ("dense", "gqa_moe", "zamba_shared"):
        shape = (*lead, B, S, cfg.n_kv_heads, cfg.head_dim)
        return {"k": _empty(*shape, dtype=dtype),
                "v": _empty(*shape, dtype=dtype)}
    if kind in ("mla_dense", "mla_moe"):
        return {"c_kv": _empty(*lead, B, S, cfg.kv_lora_rank, dtype=dtype),
                "k_rope": _empty(*lead, B, S, cfg.qk_rope_dim, dtype=dtype)}
    if kind == "mamba":
        conv, di = cfg.ssm_conv, cfg.ssm_d_inner
        gn = cfg.ssm_ngroups * cfg.ssm_state
        return {"conv_x": _empty(*lead, B, conv - 1, di, dtype=dtype),
                "conv_B": _empty(*lead, B, conv - 1, gn, dtype=dtype),
                "conv_C": _empty(*lead, B, conv - 1, gn, dtype=dtype),
                "ssm": _empty(*lead, B, cfg.ssm_nheads, cfg.ssm_headdim,
                              cfg.ssm_state, dtype=dtype)}
    raise ValueError(f"no cache layout for layer kind {kind!r}")


def cache_struct(cfg, B: int, S_max: int, dtype=torch.float32) -> list:
    """The caches of `B` sequences of up to `S_max` rows as ``meta``
    tensors: one entry per layer-program entry, in the layout of the
    module docstring (the tree `forward_prefill` returns and
    `decode_hidden` takes)."""
    out = []
    for kind, n in stack_program(cfg):
        if kind == "zamba_super":
            out.append({"mamba": _entry_struct("mamba", cfg, n, B, S_max,
                                               dtype, inner=cfg.attn_every),
                        "shared": _entry_struct("zamba_shared", cfg, n, B,
                                                S_max, dtype)})
        else:
            out.append(_entry_struct(kind, cfg, n, B, S_max, dtype))
    return out


def _by_leaf(fn, tree):
    """`fn(leaf name, leaf)` for every leaf of a cache tree, in the tree's
    structure."""
    return unflatten_like({path: fn(path.rsplit(".", 1)[-1], t)
                           for path, t in flatten(tree).items()}, tree)


def cache_init(cfg, B: int, S_max: int, dtype=torch.float32,
               device=None) -> list[dict]:
    """Zeroed caches for `B` sequences of up to `S_max` rows: the zeros of
    `cache_struct` on `device`."""
    return _by_leaf(lambda _, t: torch.zeros(t.shape, dtype=t.dtype,
                                             device=device),
                    cache_struct(cfg, B, S_max, dtype))


def cache_pspecs(cfg, mesh, B: int, S_max: int) -> list:
    """The spec of every cache leaf (JAX's ``cache_pspecs``, a tuple per
    leaf, one entry a dim): the batch over the data-parallel dims when
    they divide B, K / V and the latents' sequence over 'model' (a
    batch they do not divide spreads the sequence over the data dims and
    'model' when those divide S_max), an SSM leaf's channels or heads
    over 'model' when it divides them."""
    sizes = mesh_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    dp_size = math.prod(sizes[a] for a in dp) if dp else 1
    tp = sizes.get("model", 1)
    # one dim as its name, as a PartitionSpec holds it
    batch_ax = ((dp[0] if len(dp) == 1 else dp)
                if dp and B % dp_size == 0 else None)
    seq_ax = "model"
    if batch_ax is None and dp and S_max % (dp_size * tp) == 0:
        seq_ax = (*dp, "model")

    def spec(name, leaf):
        nd = leaf.dim()
        if name in ("k", "v"):               # (..., B, S, KV, hd)
            return (None,) * (nd - 4) + (batch_ax, seq_ax, None, None)
        if name in ("c_kv", "k_rope"):       # (..., B, S, r)
            return (None,) * (nd - 3) + (batch_ax, seq_ax, None)
        if name.startswith("conv"):          # (..., B, conv - 1, C)
            last = "model" if leaf.shape[-1] % tp == 0 else None
            return (None,) * (nd - 3) + (batch_ax, None, last)
        if name == "ssm":                    # (..., B, H, P, N)
            heads = "model" if leaf.shape[-3] % tp == 0 else None
            return (None,) * (nd - 4) + (batch_ax, heads, None, None)
        return (None,) * nd

    return _by_leaf(spec, cache_struct(cfg, B, S_max))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def cache_bytes(cfg, B: int, S_max: int, dtype=torch.float32) -> int:
    """Bytes of the whole caches of `B` sequences of `S_max` rows."""
    return sum(_nbytes(t) for t in
               flatten(cache_struct(cfg, B, S_max, dtype)).values())


def kv_broadcast_bytes(cfg, B: int, S: int, dtype=torch.float32
                       ) -> tuple[int, int]:
    """(compact, broadcast) bytes of the attention K / V tensors of a
    prefill of S tokens: the grouped (B, S, KV, hd) layout the caches
    store and the attention op reads, and what expanding K / V to every
    query head would take (H / KV times as much).  (0, 0) with no
    attention layer (a pure SSM)."""
    compact = sum(_nbytes(t) for path, t in
                  flatten(cache_struct(cfg, B, S, dtype)).items()
                  if path.rsplit(".", 1)[-1] in ("k", "v"))
    if not compact:
        return 0, 0
    return compact, compact * (cfg.n_heads // cfg.n_kv_heads)


def slot_rows(cfg, caches: list, s, kv_rows: int = 0) -> list:
    """Views of slot `s` (an index or a slice of the batch) of `caches`:
    every mamba leaf's rows (the super entries' and the tail's) and, given
    `kv_rows`, the first `kv_rows` rows of every K / V leaf (the super
    entries' shared block's, a dense stack's, an MLA entry's c_kv and
    k_rope), in one order for any caches of the program."""
    rows = []
    for (kind, _), entry in zip(stack_program(cfg), caches):
        if kind == "mamba":
            rows += [t[:, s] for t in entry.values()]
            continue
        if kind == "zamba_super":
            rows += [t[:, :, s] for t in entry["mamba"].values()]
            entry = entry["shared"]
        if kv_rows:
            rows += [t[:, s, :kv_rows] for t in entry.values()]
    return rows


def copy_prefill(cfg, buf: list, caches: list, n: int) -> None:
    """Copy the caches of a prefill of `n` positions into `buf` (from
    `cache_init`, the same batch): every mamba leaf whole, the K / V rows
    [0, n)."""
    everyone = slice(None)
    for dst, src in zip(slot_rows(cfg, buf, everyone, n),
                        slot_rows(cfg, caches, everyone, n)):
        dst.copy_(src)

"""Architecture configuration (PyTorch port of ``repro/configs/base.py``).

Every architecture is a frozen ``ArchConfig`` (hashable, so it can key a
cache); ``reduced()`` gives the small same-family config of the CPU tests.
The port carries its own copy because the JAX module imports jax.
``SHAPES``, `cell_supported` and `input_specs` are the dry run's
(launch/dryrun.py): the four cells of the JAX harness, its skip rules,
and the inputs of a cell as tensors on the ``meta`` device (the port's
``jax.ShapeDtypeStruct``).  `input_tensors` gives the same layout as
seeded tensors.  Token ids and ``pos`` are int64 where JAX has int32:
PyTorch indexes with int64.
`get_arch` knows every config of the JAX package: the dense GQA ones,
mamba2-1.3b (the SSM family), llama4-scout-17b-a16e (the MoE family's
GQA program), deepseek-v2-lite-16b (its MLA programs), internvl2-2b
(vlm), hubert-xlarge (audio) and zamba2-7b (the hybrid).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (sequence length, global batch) cell of a workload."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention flavour
    qkv_bias: bool = False
    rope_theta: float = 1e4
    causal: bool = True            # False => encoder-only (no decode)
    norm: str = "rms"              # "rms" | "layer"
    act: str = "silu"              # MLP activation (silu => SwiGLU, gelu => plain)
    # MoE
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "ep_scatter"   # "ep_scatter" | "local"  (§Perf)
    # MLA (DeepSeek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    # hybrid (Zamba2): ONE shared attention+MLP block every `attn_every`
    # mamba layers (weights reused at every invocation)
    attn_every: int = 0
    # modality frontend: "none" | "vision" | "audio" (stubs per harness)
    frontend: str = "none"
    frontend_dim: int = 0          # dim of precomputed patch/frame embeddings
    frontend_tokens: int = 0       # number of patch tokens (vision)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # ------------------------------------------------------------ derived
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 16 so the vocab dim can be
        sharded over the 16-way model axis at jit boundaries."""
        return (self.vocab_size + 15) // 16 * 16

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def attn_block_positions(self) -> list[int]:
        """Hybrid: mamba-layer indices after which the shared block runs."""
        if not self.attn_every:
            return []
        return list(range(self.attn_every - 1, self.n_layers,
                          self.attn_every))


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_MODULES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-1.5b": "qwen2_1p5b",
    "qwen2.5-3b": "qwen2p5_3b",
    "qwen2-0.5b": "qwen2_0p5b",
    "mamba2-1.3b": "mamba2_1p3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "internvl2-2b": "internvl2_2b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-7b": "zamba2_7b",
}
ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    """The ArchConfig of `name`; ValueError naming the known ones."""
    if name not in _MODULES:
        raise ValueError(f"unknown architecture {name!r}; the port has "
                         f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """The harness's skip rules: (False, reason) for a cell no step of
    the arch runs, else (True, "")."""
    if shape.kind == "decode" and arch.is_encoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.is_ssm:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{arch.name} is pure full-attention")
    return True, ""


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=min(cfg.n_layers, 2 if not cfg.attn_every else 4),
        d_model=128,
        n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2, head_dim=32,
        d_ff=256, vocab_size=512,
    )
    if cfg.is_moe:
        kw.update(n_routed_experts=4, top_k=min(cfg.top_k, 2),
                  moe_d_ff=128,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.is_mla:
        kw.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                  v_head_dim=32)
    if cfg.is_ssm:
        kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=32)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.frontend != "none":
        kw.update(frontend_dim=64,
                  frontend_tokens=min(cfg.frontend_tokens, 8) or 0)
    if cfg.n_kv_heads == cfg.n_heads:  # MHA archs stay MHA
        kw.update(n_kv_heads=4)
    return dataclasses.replace(cfg, **kw)


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    """Shape-and-dtype stand-ins for every model input of one cell: the
    tensors of `input_tensors` on the ``meta`` device (no memory).

    Train: tokens (or frames) and labels, with patch_embeds for a vision
    frontend; prefill: the same without labels; decode: token (B, 1) and
    pos, a 0-d tensor (the caches are `kvcache.cache_struct`'s).  Ids and
    pos are int64 (JAX: int32), embeddings fp32."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def ids(*size):
        return torch.empty(size, dtype=torch.int64, device=meta)

    def embeds(*size):
        return torch.empty(size, dtype=torch.float32, device=meta)

    if shape.kind == "decode":
        return {"token": ids(b, 1), "pos": ids()}
    specs: dict = {}
    if arch.frontend == "audio":
        specs["frames"] = embeds(b, s, arch.frontend_dim)
    elif arch.frontend == "vision":
        specs["tokens"] = ids(b, s - arch.frontend_tokens)
        specs["patch_embeds"] = embeds(b, arch.frontend_tokens,
                                       arch.frontend_dim)
    else:
        specs["tokens"] = ids(b, s)
    if shape.kind == "train":
        specs["labels"] = ids(b, s)
    return specs


def input_tensors(arch: ArchConfig, shape: ShapeConfig, *,
                  generator: torch.Generator, device=None) -> dict:
    """The model inputs of one (arch, shape) cell in the JAX
    ``input_specs`` layout, as tensors drawn from `generator` (which lives
    on `device`).

    Train and prefill: ``tokens`` (B, S) int64, or for a vision frontend
    (B, S - frontend_tokens) beside ``patch_embeds`` (B, frontend_tokens,
    frontend_dim) fp32, or for an audio frontend ``frames`` (B, S,
    frontend_dim) fp32 in place of tokens; train adds ``labels`` (B, S).
    Decode: ``token`` (B, 1) and ``pos``, a 0-d int64 tensor (0).  Token
    ids lie in [0, vocab_size); embeddings are standard normal.
    """
    b, s = shape.global_batch, shape.seq_len

    def ids(*size):
        return torch.randint(0, arch.vocab_size, size, generator=generator,
                             device=device)

    def normal(*size):
        return torch.randn(size, generator=generator, device=device)

    if shape.kind == "decode":
        return {"token": ids(b, 1),
                "pos": torch.zeros((), dtype=torch.int64, device=device)}
    inputs: dict = {}
    if arch.frontend == "audio":
        inputs["frames"] = normal(b, s, arch.frontend_dim)
    elif arch.frontend == "vision":
        inputs["tokens"] = ids(b, s - arch.frontend_tokens)
        inputs["patch_embeds"] = normal(b, arch.frontend_tokens,
                                        arch.frontend_dim)
    else:
        inputs["tokens"] = ids(b, s)
    if shape.kind == "train":
        inputs["labels"] = ids(b, s)
    return inputs

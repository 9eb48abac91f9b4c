"""Architecture configuration (PyTorch port of ``repro/configs/base.py``).

Every architecture is a frozen ``ArchConfig`` (hashable, so it can key a
cache); ``reduced()`` gives the small same-family config of the CPU tests.
The port carries its own copy because the JAX module imports jax.  The
input specs and the ``SHAPES`` of the JAX dry run stay behind: the port has
no dry run; `ShapeConfig` comes along for the trainer's data pipeline.  `get_arch` knows the dense GQA configs the port runs; the
other families come with their model code.
"""
from __future__ import annotations

import dataclasses
import importlib

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


_MODULES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-1.5b": "qwen2_1p5b",
    "qwen2.5-3b": "qwen2p5_3b",
    "qwen2-0.5b": "qwen2_0p5b",
}
ARCH_IDS = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    """The ArchConfig of `name`; ValueError naming the known ones."""
    if name not in _MODULES:
        raise ValueError(f"unknown or unported architecture {name!r}; the "
                         f"port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


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

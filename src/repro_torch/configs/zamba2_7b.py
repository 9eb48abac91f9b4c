"""zamba2-7b [hybrid] — Mamba2 backbone + ONE shared attention block
[arXiv:2411.15242].

81 Mamba2 layers, d_model=3584, ssm_state=64; a single shared
attention(32H MHA)+MLP(d_ff=14336) block is invoked every 6 mamba layers
with reused weights (per-invocation LoRA deltas omitted, as in the JAX
config).
The shared block consumes concat(hidden, embedding) -> 2d->d projection,
as in the Zamba papers.  Layer program: 13 super entries of 6 mamba layers
and the shared block, then a tail of 3 mamba layers; 6,623,604,944
parameters (26.5 GB in fp32), which one H100 holds whole.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,             # shared block is MHA
    head_dim=112,
    d_ff=14336,                # shared block MLP
    vocab_size=32000,
    rope_theta=1e4,
    norm="rms",
    act="gelu",                # zamba2 shared MLP uses gelu
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,             # zamba2 uses grouped B/C; 1 group kept
    ssm_chunk=256,
    attn_every=6,
    tie_embeddings=True,
)

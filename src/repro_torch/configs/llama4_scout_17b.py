"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert
[hf:meta-llama/Llama-4-Scout-17B-16E].

48L d_model=5120 40H (GQA kv=8) expert d_ff=8192 vocab=202048, MoE every
layer (interleave step 1 for Scout), top-1 routed + 1 always-on shared
expert.  "Early fusion" multimodality is stubbed text-only, and the
NoPE-every-4th-layer and QK-norm details are omitted (RoPE everywhere), as
in the JAX package's config: the attention math is unchanged.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                 # shared-expert / dense ff width
    vocab_size=202048,
    rope_theta=5e5,
    norm="rms",
    act="silu",
    n_routed_experts=16,
    n_shared_experts=1,
    top_k=1,
    moe_d_ff=8192,
    first_dense_layers=0,
)

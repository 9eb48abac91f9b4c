"""deepseek-v2-lite-16b [moe] — MLA + fine-grained MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(moe)=1408 vocab=102400.
MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128 (no q compression
in -lite).  MoE: first layer dense (d_ff=10944), then 2 shared + 64 routed
experts, top-6.  DeepSeek-V2 (full) routes over 160 experts; hf's v2-lite
config has 64, which this config follows, as the JAX package's does.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,             # MLA: all heads share the compressed cache
    head_dim=192,              # qk_nope + qk_rope
    d_ff=10944,                # dense first layer
    vocab_size=102400,
    rope_theta=1e4,
    norm="rms",
    act="silu",
    n_routed_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)

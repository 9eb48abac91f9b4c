"""qwen2.5-3b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5 family].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    norm="rms",
    act="silu",
    tie_embeddings=True,
)

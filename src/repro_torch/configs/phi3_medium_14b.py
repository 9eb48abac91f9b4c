"""phi3-medium-14b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=1e4,
    norm="rms",
    act="silu",
)

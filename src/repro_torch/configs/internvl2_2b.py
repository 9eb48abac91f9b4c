"""internvl2-2b [vlm] — InternViT frontend (stub) + InternLM2 backbone.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553 [arXiv:2404.16821; hf].
The ViT is a stub, as in the JAX package's config: the inputs carry
precomputed patch embeddings (InternViT-300M hidden 1024); the model owns
the MLP projector (`models/frontend.py`).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,          # padded to 92560 (a multiple of 16)
    rope_theta=1e6,
    norm="rms",
    act="silu",
    frontend="vision",
    frontend_dim=1024,         # InternViT-300M hidden size
    frontend_tokens=256,       # one 448px tile -> 256 visual tokens
)

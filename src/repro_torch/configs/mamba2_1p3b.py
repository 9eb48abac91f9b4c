"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
d_inner = 2*2048 = 4096, headdim 64 -> 64 SSD heads, ngroups 1, conv 4.
No MLP blocks: the Mamba2 mixer is the whole layer (d_ff=0).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0, n_kv_heads=0, head_dim=0,   # attention-free
    d_ff=0,
    vocab_size=50280,          # padded to 50288
    norm="rms",
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)

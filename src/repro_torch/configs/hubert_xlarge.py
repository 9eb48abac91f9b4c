"""hubert-xlarge [audio] — encoder-only transformer [arXiv:2106.07447].

48L d_model=1280 16H (MHA kv=16) d_ff=5120 vocab=504 (k-means targets).
Same backbone as wav2vec2; the conv waveform frontend is a stub, as in the
JAX package's config: the inputs carry precomputed frame embeddings (dim
512).  Encoder-only: no decode step (`serve_step.make_forward_step`).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,            # padded to 512
    causal=False,              # bidirectional encoder
    norm="layer",
    act="gelu",
    frontend="audio",
    frontend_dim=512,          # conv feature extractor output dim
)

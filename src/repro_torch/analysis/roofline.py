"""Three-term roofline of one step (PyTorch port of
``repro/analysis/roofline.py``), in seconds a step on one NVIDIA H100 80GB
HBM3 (SXM, 700 W):

    compute    = FLOPs_per_chip / peak FLOP/s of the dtype
    memory     = bytes_per_chip / HBM rate
    collective = link bytes_per_chip / NVLink rate

The dry run (launch/dryrun.py) fills the terms: the FLOPs that
``torch.utils.flop_counter.FlopCounterMode`` counts on the step's trace on
the ``meta`` device, the per-rank bytes of the step's arguments read once
and its outputs written once, and the bytes of the collectives the
sharded backend's paths issue (`kernels.sharded.route`).

The figures are NVIDIA's data-sheet numbers for the H100 SXM:
  * fp32 67 TFLOP/s, the CUDA cores' FFMA rate.  fp32_strict runs with
    TF32 off, so the tensor cores' TF32 rate is not its peak;
  * bf16 989 TFLOP/s, the tensor cores' dense rate;
  * HBM3 3.35 TB/s and 80 GB;
  * NVLink 450 GB/s a direction (900 GB/s both ways).
"""
from __future__ import annotations

import dataclasses

HW = {
    "peak_bf16": 989e12,
    "peak_fp32": 67e12,
    "hbm_bw": 3.35e12,
    "link_bw": 450e9,
    "hbm_bytes": 80e9,
}


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    dtype: str                      # "fp32" | "bf16"
    chips: int
    model_flops: float              # 6·N·D or 2·N_active·D (+KV attention)

    @property
    def peak(self) -> float:
        return HW["peak_fp32"] if self.dtype == "fp32" else HW["peak_bf16"]

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HW["hbm_bw"]

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / HW["link_bw"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: what remat, padding and capacity
        add."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Best-case MFU if the step runs exactly at the dominant term."""
        t = self.t_bound
        if t == 0:
            return 0.0
        return self.model_flops / (t * self.chips * self.peak)

    def to_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "mfu_bound": self.mfu_bound,
            "model_flops": self.model_flops,
            "chips": self.chips,
            "dtype": self.dtype,
        }


def model_flops_for(cfg, shape, total_params: int, active_params: int
                    ) -> float:
    """MODEL_FLOPS for the cell: 6·N·D train, 2·N_active·D decode/prefill,
    plus causal attention KV FLOPs where the arch has attention."""
    D_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    n = active_params
    base = (6 if shape.kind == "train" else 2) * n * D_tokens
    # QK^T and PV over the query heads: 4 * B * S * ctx * H * hd (x3 to
    # train, forward and backward)
    if cfg.n_heads:
        H, hd = cfg.n_heads, (cfg.head_dim if not cfg.is_mla
                              else cfg.qk_nope_dim + cfg.qk_rope_dim)
        n_attn_layers = (cfg.n_layers if cfg.family != "hybrid"
                         else cfg.n_layers // cfg.attn_every)
        if shape.kind == "decode":
            ctx = shape.seq_len
            attn = 4 * shape.global_batch * 1 * ctx * H * hd * n_attn_layers
        else:
            ctx = shape.seq_len / 2 if cfg.causal else shape.seq_len
            attn = (4 * shape.global_batch * shape.seq_len * ctx * H * hd
                    * n_attn_layers)
            if shape.kind == "train":
                attn *= 3
        base += attn
    return float(base)

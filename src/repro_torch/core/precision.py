"""Precision policies: the paper's "non-quantized" contract, made explicit
(PyTorch port of ``repro/core/precision.py``).

The paper keeps every network parameter at full precision and wins
performance through the engine, not through quantization.  That is an
invariant (`assert_non_quantized`) plus two compute policies:

  fp32_strict : paper-faithful.  fp32 storage, true fp32 products, fp32
                accumulation.  On the card that means no TF32 anywhere:
                the engine turns it off in PyTorch, and the port's kernel
                runs fp32 FFMAs, no tensor cores.
  mixed       : fp32 master parameters, bf16 operands, fp32 accumulation.
                Still "non-quantized" in the paper's sense: no integer or
                narrow-integer representation anywhere.

Integer dtypes anywhere in a state dict are a policy violation.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

POLICIES = ("fp32_strict", "mixed")


@dataclasses.dataclass(frozen=True)
class Precision:
    policy: str = "fp32_strict"

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown precision policy {self.policy!r}; "
                             f"choose from {POLICIES}")

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.float32  # always: non-quantized master params

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.float32 if self.policy == "fp32_strict"
                else torch.bfloat16)

    @property
    def reduce_dtype(self) -> torch.dtype:
        """Dtype the plain (`eager`) GEMM emits before its epilogue: f32
        under fp32_strict, bf16 under mixed, as the JAX `xla` backend.
        The kernel keeps its fp32 accumulator to the epilogue either way."""
        return self.compute_dtype


def assert_non_quantized(state: Mapping[str, torch.Tensor]) -> None:
    """Raises if any tensor of a state dict has an integer or quantized
    dtype."""
    for name, t in state.items():
        if t.is_quantized or not (t.is_floating_point() or t.is_complex()
                                  or t.dtype == torch.bool):
            raise ValueError(f"non-quantization policy violated at {name}: "
                             f"dtype {t.dtype}")

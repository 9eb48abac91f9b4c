"""Public compute-engine API of the PyTorch port.

One `ComputeEngine` serving every dense layer, backed by a backend/op
registry (`backends.py`) and the non-quantization precision contract
(`precision.py`).  Import from here:

    from repro_torch.core import ComputeEngine, make_engine, register_backend

Importing this package registers the built-in backends `ref`, `eager` and
`cuda` (core/backends.py at module load).  It builds no kernel and needs no
GPU: the CUDA kernels are built at their first launch.
"""
from repro_torch.core.backends import (OP_SET, counts_since,
                                       dispatch_counts, get_backend,
                                       list_backends, register_backend,
                                       reset_dispatch_counts)
from repro_torch.core.compile_cache import (StepCompileCache,
                                            normalize_buckets, pick_bucket)
from repro_torch.core.engine import ComputeEngine, make_engine
from repro_torch.core.precision import Precision, assert_non_quantized

__all__ = ["ComputeEngine", "make_engine", "Precision",
           "assert_non_quantized", "OP_SET", "register_backend",
           "get_backend", "list_backends", "dispatch_counts",
           "counts_since", "reset_dispatch_counts", "StepCompileCache",
           "normalize_buckets", "pick_bucket"]

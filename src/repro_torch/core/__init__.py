"""Public compute-engine API of the PyTorch port.

One `ComputeEngine` serving every dense layer, backed by a backend/op
registry (`backends.py`) and the non-quantization precision contract
(`precision.py`).  Import from here:

    from repro_torch.core import ComputeEngine, make_engine, register_backend

Importing this package registers the built-in backends `ref`, `eager` and
`cuda` (core/backends.py at module load) and `sharded_cuda`
(core/shard_backend.py, below).  It builds no kernel and needs no
GPU: the CUDA kernels are built at their first launch.
"""
from repro_torch.core.backends import (AUTOTUNE_POLICIES, OP_SET,
                                       autotune_policy, autotune_report,
                                       counts_since, dispatch_counts,
                                       get_autotune_policy, get_backend,
                                       list_backends, register_backend,
                                       reset_dispatch_counts,
                                       set_autotune_policy)
from repro_torch.core.compile_cache import (StepCompileCache,
                                            normalize_buckets, pick_bucket)
from repro_torch.core.engine import ComputeEngine, make_engine
from repro_torch.core import shard_backend as _shard_backend  # noqa: F401
from repro_torch.core.precision import Precision, assert_non_quantized

__all__ = ["ComputeEngine", "make_engine", "Precision",
           "assert_non_quantized", "OP_SET", "register_backend",
           "get_backend", "list_backends", "dispatch_counts",
           "counts_since", "reset_dispatch_counts", "StepCompileCache",
           "normalize_buckets", "pick_bucket", "AUTOTUNE_POLICIES",
           "autotune_policy", "autotune_report", "get_autotune_policy",
           "set_autotune_policy"]

"""Trace-lint rule registrations.

Importing this package registers the shipped rules with
`repro_torch.analysis.lint.RULES` (the runner imports it lazily, so a
hand-built `LintContext` unit test never needs to).  Each rule lives in its
own module; see docs/lint.md for the catalog.
"""
from repro_torch.analysis.rules import (  # noqa: F401
    r001_head_broadcast,
    r002_registry_dispatch,
    r003_dtype_hygiene,
    r004_kernel_params,
    r005_const_bloat,
)

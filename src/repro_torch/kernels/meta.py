"""The kernels' shape-only rules: what a run on the meta device records.

The dry run (:mod:`repro_torch.launch.dryrun`) runs a rank's step on the
``meta`` device, where tensors have shapes and no data. A kernel wrapper
given meta tensors runs its **meta rule** instead of a launch: it checks
its operands as its CUDA branch does, allocates on meta exactly the
outputs and workspaces that branch allocates (the GEMMs' split-K planes,
the ``NO_FLUSH`` int32 sums, the fused kernels' row scales, K7's scales),
launches nothing, and records its kernel's work here, by the formulas of
the kernel table's bound column (``PERF.md``): 2·M·N·K operations for a
GEMM, 3·M·K for K7, and the bytes of its operands, scales and outputs,
each moved once. A meta rule never bumps a wrapper's ``launches``.

The wrappers without a rule (K2, K3, K8: the paged engine's attention
and the flash attention, which the dry run's paths never reach) raise on
meta (:func:`no_rule`); no meta tensor reaches a plain version.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

# the active dry run's sink: (kernel, operations, bytes) -> None
_sink: Optional[Callable[[str, float, float], None]] = None


def nbytes(*tensors) -> int:
    """The bytes of ``tensors`` (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def record(kernel: str, ops: float, n_bytes: float) -> None:
    """One kernel call's work, into the active dry run (if any)."""
    if _sink is not None:
        _sink(kernel, float(ops), float(n_bytes))


@contextlib.contextmanager
def recording(sink: Callable[[str, float, float], None]):
    """Send every meta rule's record to ``sink`` while the block runs."""
    global _sink
    prev, _sink = _sink, sink
    try:
        yield
    finally:
        _sink = prev


def no_rule(what: str, x: torch.Tensor) -> None:
    """Raise for a meta tensor at a kernel without a meta rule."""
    if x.is_meta:
        raise NotImplementedError(
            f"{what}: no meta rule (the dry run's paths do not reach this "
            "kernel, and a meta tensor never takes its plain version)")

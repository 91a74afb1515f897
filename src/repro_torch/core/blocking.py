"""Launch plans of the int8 tensor-core GEMM template on Hopper.

Port of ``repro/core/blocking.py``. The reference picks TPU blocks
(bm, bn, bk) that fit VMEM beside the MXU's 128 × 128 tiles. On the H100
the template behind K1, K4, K5, K6a and K6b (``csrc/camp_gemm_tc.cuh``)
fixes a block's output columns (``TC_BN``, the wgmma rows of Cᵀ = Bᵀ Aᵀ)
and its K step (``TC_BK``, one 128-byte swizzle panel) at compile time,
and takes at run time:

* the row tile MT, one of ``TC_ROW_TILES`` (an instance each);
* the split of K: ``splits`` runs of ``per`` K steps, each run's exact
  int32 partial sums in its own workspace plane, added in split order by
  the flush, so the output does not depend on the split;
* the flags: ``FLUSH_IN_BLOCK`` (one split: the product block flushes
  its own sums, no flush kernel) and, for the fused kernels,
  ``SCALE_KERNEL`` (the row scales from a scale pass kernel rather than
  the block's own warps). ``SPLIT_SCALES`` is a control that is wrong on
  purpose and never part of a plan; ``NO_FLUSH`` (the int32 sums as the
  output of K5 / K6a / K6b, for a sum over ranks before the flush) is
  set by the call, never by a plan.

A plan is those four numbers (:class:`PlanConfig`).
:func:`choose_plan` is the analytic pick, the seed that the autotune
(:mod:`repro_torch.core.autotune`) measures its neighbours against: the
smallest row tile that holds M, then K split so that the grid comes to
about one block an SM.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

TC_BN = 128           # output columns a block of the tensor-core template
TC_BK = 128           # K a step
TC_ROW_TILES = (8, 32, 128)
# csrc/camp_gemm_tc.cuh's Flags
FLUSH_IN_BLOCK = 1    # one split: the product block flushes its own sums
SCALE_KERNEL = 2      # fused: row scales from a scale pass kernel
SPLIT_SCALES = 4      # fused: each block's scales from its own K range
                      # (wrong on purpose: chip_smoke.py's control)
NO_FLUSH = 8          # pre-quantized A: the int32 sums are the output
                      # (set by the call, never part of a plan)
# the fused kernels' row tiles whose scales come from the scale pass (at
# the others each block reduces its own rows of x): the faster choice per
# row tile at the serving shapes (PERF.md)
SCALE_KERNEL_ROW_TILES = (32, 128)

# The card's limits: H100 SXM (NVIDIA data sheet), at its 700 W limit
HBM_BYTES_PER_S = 3.35e12         # HBM3
INT8_OPS_PER_S = 1979e12          # dense int8 tensor-core peak
BF16_OPS_PER_S = 989e12           # dense bf16 tensor-core peak
SMEM_PER_BLOCK = 227 * 1024       # opt-in dynamic shared memory a block
H100_SMS = 132                    # SMs of the H100 SXM, where no card is seen


class PlanConfig(NamedTuple):
    """One launch of the tensor-core template: row tile, number of K
    splits, K steps a split, flags."""
    mt: int
    splits: int
    per: int
    flags: int

    def smem_bytes(self, w4: bool) -> int:
        """Dynamic shared memory of one product block with packed-int4 B
        (``w4``: K4, K6a, K6b) or int8 B (K1, K5); the same for every A
        kind. Mirrors ``Tile<W4, MT>::SMEM`` of ``csrc/camp_gemm_tc.cuh``
        (``chip_smoke.py`` holds it to the built library's
        ``camp_gemm_tc_smem``)."""
        stages = 5 if self.mt == 128 else 8
        slot = self.mt * TC_BK + (TC_BK // 2 if w4 else TC_BK) * TC_BN
        bar = 2 * TC_BN * TC_BK + stages * slot
        return 1024 + bar + 8 * stages + 8 * self.mt


def sm_count() -> int:
    """SMs of the current CUDA card, or the H100 SXM's where there is
    none (the plans a CPU process computes are the H100's)."""
    if not torch.cuda.is_available():
        return H100_SMS
    return build.sm_count(torch.cuda.current_device())


def k_steps(k: int) -> int:
    return max(1, -(-k // TC_BK))


def split_plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int, int]:
    """(MT, splits, K steps a split) for the tensor-core template at an
    (M, K) x (K, N) product on a card of ``sms`` SMs: the smallest row
    tile that holds M (else 128), then the K steps split into equal runs
    so that the grid comes to about one block an SM, at least one step a
    split."""
    mt = next((t for t in TC_ROW_TILES if m <= t), TC_ROW_TILES[-1])
    tiles = -(-n // TC_BN) * -(-m // mt)
    steps = k_steps(k)
    want = max(1, min(steps, sms // tiles))
    per = -(-steps // want)
    return mt, -(-steps // per), per


def tc_flags(m: int, n: int, plan: Tuple[int, int, int], sms: int,
             fused: bool) -> int:
    """The tensor-core template's flags for an (M, N) output under
    ``plan`` on a card of ``sms`` SMs: the product block flushes its own
    sums where there is one split and the grid fills the card (with fewer
    blocks than SMs, a flush kernel over the whole card is faster: silu
    and mul at M 256, N 4,864); the fused kernels take their row scales
    from the scale pass at the row tiles of ``SCALE_KERNEL_ROW_TILES``."""
    mt, splits, _ = plan
    flags = 0
    if splits == 1 and -(-n // TC_BN) * -(-m // mt) >= sms:
        flags |= FLUSH_IN_BLOCK
    if fused and mt in SCALE_KERNEL_ROW_TILES:
        flags |= SCALE_KERNEL
    return flags


def choose_plan(m: int, n: int, k: int, sms: int, fused: bool) -> PlanConfig:
    """The analytic plan (:func:`split_plan` with :func:`tc_flags`): the
    autotune's seed, and what a GEMM launches until a shape is tuned."""
    plan = split_plan(m, n, k, sms)
    return PlanConfig(*plan, tc_flags(m, n, plan, sms, fused))


def valid_plan(plan: PlanConfig, k: int, *, fused: bool, w4: bool) -> bool:
    """Can the template run ``plan`` for logical K ``k``, and give the
    exact result: a row tile it has an instance of, splits that cover the
    K steps with none empty, ``FLUSH_IN_BLOCK`` only with one split,
    ``SCALE_KERNEL`` only where x is quantized in the kernel, never
    ``SPLIT_SCALES``, and a block within the card's shared memory."""
    mt, splits, per, flags = plan
    known = FLUSH_IN_BLOCK | (SCALE_KERNEL if fused else 0)
    return (mt in TC_ROW_TILES and per >= 1 and splits >= 1
            and splits == -(-k_steps(k) // per)
            and not flags & ~known
            and (splits == 1 or not flags & FLUSH_IN_BLOCK)
            and plan.smem_bytes(w4) <= SMEM_PER_BLOCK)

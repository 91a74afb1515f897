"""K5: int8 GEMM of pre-quantized activations, and the launch plumbing of
every CAMP GEMM kernel.

Port of the reference's ``camp_gemm_i8`` (``repro/kernels/camp_gemm.py``):
int8 A (M, K) with row scales (M, 1) times int8 B (K, N) with column scales
(1, N), accumulated in int32 and flushed as ``acc · (s_a · s_b)`` followed
by the epilogue stages (:func:`repro_torch.kernels.ref.flush_ref`). It is
the unfused path's GEMM: ``quantize_rowwise`` (K7) then this kernel equals
the fused K1 bit for bit. With ``out_dtype=torch.int32`` K5, K6a and K6b
return the int32 sums unflushed (``NO_FLUSH``): a row-parallel product on
the dense slab sums them over the ranks, exactly, and flushes once
(:func:`flush`), as GSPMD reduces the reference's int32 dot.

* :func:`camp_gemm_i8_ref` is the plain PyTorch version.
* :func:`camp_gemm_i8` is the wrapper: a CPU tensor goes to the plain
  version; a CUDA tensor launches ``csrc/camp_gemm.cu`` (or raises); a
  meta tensor runs the kernel's meta rule (:mod:`repro_torch.kernels.
  meta`: the same outputs and workspace allocated, nothing launched).
  ``launches`` counts kernel launches.
* :func:`launch_gemm` binds the C signature of the tensor-core template
  ``csrc/camp_gemm_tc.cuh`` (K1, K4, K5, K6a, K6b): the flush's arguments
  (``csrc/camp_gemm_common.cuh``'s ``GemmArgs``), then an int32 workspace
  (the fused kernels' row scales, then the partial sums), the row tile,
  the split of K and the flags of a
  :class:`~repro_torch.core.blocking.PlanConfig`.
* The wrappers take their plan from :func:`repro_torch.core.autotune.
  get_plan` (the measured plan of a tuned shape, else the analytic seed
  :func:`repro_torch.core.blocking.choose_plan`), or from ``plan=``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import autotune
from repro_torch.core.blocking import (FLUSH_IN_BLOCK, NO_FLUSH,
                                       SCALE_KERNEL, PlanConfig,
                                       choose_plan, sm_count, tc_flags)
from repro_torch.kernels import build, meta
from repro_torch.kernels.epilogue import EPILOGUE_STAGES, validate_epilogue
from repro_torch.kernels.ref import dot_i32, flush_ref

launches = 0          # kernel launches through the wrapper

FLOATS = (torch.float32, torch.bfloat16)
_VOID, _INT = ctypes.c_void_p, ctypes.c_int
# the flush's arguments, then workspace, MT, splits, K steps a split,
# flags, the stream
_ARGTYPES = [_VOID, _INT, _VOID, _VOID, _VOID, _VOID, _INT, _VOID, _INT,
             _VOID, _INT, _INT, _INT, _INT, _INT, _INT,
             _VOID, _INT, _INT, _INT, _INT, _VOID]
_fns = {}

def device_kernels(flags: int) -> int:
    """Device kernels one tensor-core call launches under ``flags``: the
    scale pass, the product, the flush kernel."""
    return (1 + bool(flags & SCALE_KERNEL)
            + (not flags & FLUSH_IN_BLOCK))


def tc_smem_bytes(w4: bool, mt: int) -> int:
    """Dynamic shared memory of one product block of the tensor-core
    template with packed-int4 B (``w4``: K4, K6a) or int8 B (K1, K5) and
    row tile ``mt``, read from the built library."""
    fn = build.load("camp_gemm").camp_gemm_tc_smem
    fn.argtypes, fn.restype = [_INT, _INT], _INT
    return fn(int(w4), mt)


def sms_of(a: torch.Tensor) -> int:
    """SMs of the card that ``a`` lies on (a meta tensor: the current
    card's, or the H100's where there is none)."""
    if a.is_meta:
        return sm_count()
    index = (a.device.index if a.device.index is not None
             else torch.cuda.current_device())
    return build.sm_count(index)


def plan_for(a: torch.Tensor, n: int, k: int, fused: bool) -> PlanConfig:
    """The analytic plan (:func:`~repro_torch.core.blocking.choose_plan`)
    for ``a``'s rows on ``a``'s card."""
    return choose_plan(a.shape[0], n, k, sms_of(a), fused)


def check_tensor(name, t, shape, dtypes, device):
    """Raise unless ``t`` is on ``device``, of ``shape``, one of ``dtypes``
    and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is on a card, or on meta (the meta rule)."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: no kernel for {t.device}")


def launch_gemm(lib: str, symbol: str, a, a_scale, b, b_scale, k: int, *,
                out_dtype, epilogue: str, bias, operand,
                plan: Tuple[int, int, int],
                flags: Optional[int] = None) -> torch.Tensor:
    """Check the flush's tensors, allocate the (M, N) output and launch the
    tensor-core instance ``symbol`` of ``csrc/<lib>.cu`` for the logical K
    ``k``. ``a``/``b`` are checked by the caller; ``a_scale`` is None for
    the fused kernels, which compute it. ``plan`` (MT, splits, K steps a
    split) and ``flags`` (default :func:`tc_flags`) shape the launch, with
    one int32 workspace: the fused kernels' M row scales (f32), then each
    split's partial sums, (splits, M, N), unless the product block
    flushes. ``out_dtype=torch.int32`` (pre-quantized A only): no flush,
    the planes added are the output."""
    if out_dtype == torch.int32:
        return _launch_acc(lib, symbol, a, a_scale, b, b_scale, k,
                           epilogue=epilogue, bias=bias, operand=operand,
                           plan=plan, flags=flags)
    stages = validate_epilogue(epilogue, bias, operand)
    m, n, dev = a.shape[0], b.shape[1], a.device
    check_tensor("b_scale", b_scale.reshape(1, -1), (1, n), (torch.float32,),
                 dev)
    if not b_scale.is_contiguous():
        raise ValueError("b_scale must be contiguous")
    if a_scale is not None:
        check_tensor("a_scale", a_scale, (m, 1), (torch.float32,), dev)
    if bias is not None:
        check_tensor("bias", bias.reshape(-1), (n,), FLOATS, dev)
    if operand is not None:
        check_tensor("operand", operand, (m, n), FLOATS, dev)
    if out_dtype not in FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {FLOATS}")
    code = 0
    for i, s in enumerate(stages):
        code |= (EPILOGUE_STAGES.index(s) + 1) << (4 * i)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0 or n == 0:
        return out
    mt, splits, per = plan
    fused = a_scale is None
    if flags is None:
        flags = tc_flags(m, n, plan, sms_of(a), fused)
    rows = -(-m // 4) * 4 if fused else 0    # planes 16-byte aligned
    planes = 0 if flags & FLUSH_IN_BLOCK else splits * m * n
    ws = torch.empty(rows + planes, dtype=torch.int32, device=dev)
    if dev.type == "meta":
        meta.record(symbol, 2.0 * m * n * k,
                    meta.nbytes(a, a_scale, b, b_scale, bias, operand, out))
        return out
    fn = _symbol_fn(lib, symbol)

    def bf16(t):
        return int(t is not None and t.dtype == torch.bfloat16)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = [a.data_ptr(), bf16(a), ws.data_ptr() if fused else ptr(a_scale),
            b.data_ptr(), b_scale.data_ptr(), ptr(bias), bf16(bias),
            ptr(operand), bf16(operand), out.data_ptr(), bf16(out), m, n, k,
            code, len(stages),
            ws.data_ptr() + 4 * rows if planes else None, mt, splits, per,
            flags]
    rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")
    return out


def _symbol_fn(lib: str, symbol: str):
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(build.load(lib), symbol)
        fn.argtypes = _ARGTYPES
        fn.restype = _INT
        _fns[symbol] = fn
    return fn


def _launch_acc(lib, symbol, a, a_scale, b, b_scale, k, *, epilogue, bias,
                operand, plan, flags):
    """:func:`launch_gemm` with int32 out: the product kernel alone, its
    splits' planes added (int32: exact) → (M, N) int32."""
    if a_scale is None:
        raise ValueError("int32 out takes pre-quantized A (K5, K6a, K6b)")
    if validate_epilogue(epilogue, bias, operand):
        raise ValueError("int32 out has no flush: epilogue 'none' only")
    m, n, dev = a.shape[0], b.shape[1], a.device
    check_tensor("a_scale", a_scale, (m, 1), (torch.float32,), dev)
    check_tensor("b_scale", b_scale.reshape(1, -1), (1, n), (torch.float32,),
                 dev)
    mt, splits, per = plan
    if flags is None:
        flags = tc_flags(m, n, plan, sms_of(a), False)
    flags = (flags & ~FLUSH_IN_BLOCK) | NO_FLUSH
    ws = torch.empty((splits, m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return ws.sum(dim=0, dtype=torch.int32)
    if dev.type == "meta":
        meta.record(symbol, 2.0 * m * n * k,
                    meta.nbytes(a, a_scale, b, b_scale, ws))
        return ws[0] if splits == 1 else ws.sum(dim=0, dtype=torch.int32)
    args = [a.data_ptr(), 0, a_scale.data_ptr(), b.data_ptr(),
            b_scale.data_ptr(), None, 0, None, 0, ws.data_ptr(), 0, m, n, k,
            0, 0, ws.data_ptr(), mt, splits, per, flags]
    rc = _symbol_fn(lib, symbol)(*args,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {rc}")
    return ws[0] if splits == 1 else ws.sum(dim=0, dtype=torch.int32)


def flush(acc: torch.Tensor, a_scale, b_scale, *, out_dtype=torch.float32
          ) -> torch.Tensor:
    """The flush of int32 sums that K5 / K6a / K6b returned unflushed and
    the ranks added: acc (..., M, N), ``a_scale`` (..., M, 1), ``b_scale``
    (..., 1, N) → ``acc · (s_a · s_b)`` in ``out_dtype``, elementwise: the
    kernels' flush with no stage (``camp::flush_one``,
    :func:`~repro_torch.kernels.ref.flush_ref`) bit for bit."""
    return (acc.float() * (a_scale * b_scale)).to(out_dtype)


def camp_gemm_i8_ref(a_q, b_q, a_scale, b_scale, *, out_dtype=torch.float32,
                     epilogue: str = "none", bias=None, operand=None,
                     dot=dot_i32):
    """Plain version: exact int32 dot (or ``dot``, e.g. the hybrid
    decomposition) → flush → stages; ``out_dtype=torch.int32``: the dot
    unflushed."""
    if out_dtype == torch.int32:
        if validate_epilogue(epilogue, bias, operand):
            raise ValueError("int32 out has no flush: epilogue 'none' only")
        return dot(a_q, b_q)
    return flush_ref(dot(a_q, b_q), a_scale, b_scale, out_dtype=out_dtype,
                     epilogue=epilogue, bias=bias, operand=operand)


def camp_gemm_i8(a_q: torch.Tensor, b_q: torch.Tensor, a_scale: torch.Tensor,
                 b_scale: torch.Tensor, *, out_dtype=torch.float32,
                 epilogue: str = "none", bias: Optional[torch.Tensor] = None,
                 operand: Optional[torch.Tensor] = None,
                 plan: Optional[PlanConfig] = None) -> torch.Tensor:
    """int8 A (M, K), scales (M, 1) f32 × int8 B (K, N), scales (1, N) f32
    → (M, N) in ``out_dtype`` (bf16 or f32; int32: the sums unflushed).
    ``plan`` (a CUDA tensor only) overrides the autotune's."""
    kw = dict(out_dtype=out_dtype, epilogue=epilogue, bias=bias,
              operand=operand)
    if a_q.device.type == "cpu":
        return camp_gemm_i8_ref(a_q, b_q, a_scale, b_scale, **kw)
    require_cuda(a_q, "camp_gemm_i8")
    if a_q.ndim != 2 or b_q.ndim != 2:
        raise ValueError("camp_gemm_i8 takes 2-D a_q and b_q")
    (m, k), n = a_q.shape, b_q.shape[1]
    check_tensor("a_q", a_q, (m, k), (torch.int8,), a_q.device)
    check_tensor("b_q", b_q, (k, n), (torch.int8,), a_q.device)
    plan = plan or autotune.get_plan("i8", m, n, k)
    out = launch_gemm("camp_gemm", "camp_gemm_i8", a_q, a_scale, b_q,
                      b_scale, k, plan=plan[:3], flags=plan.flags, **kw)
    if out.numel() and out.is_cuda:
        global launches
        launches += 1
    return out

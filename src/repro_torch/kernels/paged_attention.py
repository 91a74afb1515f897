"""K3: paged single-token decode attention over int8 KV pages.

Port of the reference's ``paged_attention`` (``repro/kernels/
paged_attention.py``). Layout: q (B, KV, G, hd), one token per sequence
with the G query heads of a kv head folded together; pages (P, KV, ps, hd)
int8; per-token scales (P, KV, ps) f32; tables (B, max_pages) int32 (rows
padded past a sequence's last page); lengths (B,) int32 (≥ 1).

* :func:`paged_attention_reference` is the plain PyTorch version (gather →
  dequantize → masked softmax).
* :func:`paged_attention` dispatches by ``impl`` (see
  :mod:`repro_torch.kernels.ops`); :func:`paged_attention_cuda` is the
  wrapper around ``csrc/paged_attention.cu``, whose ``launches`` counts.

Float pages (scales None, the pool's ``quantized=False``) take the plain
version on every device, as in the reference, whose Pallas kernel runs
only for int8 pages: the kernel, like the TPU kernel it replaces, reads
int8 pages with per-token scales.

The head-sharded tensor-parallel wrapper (``paged_attention_tp``) comes
with tensor parallelism in a later slice.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ops import check_impl

_NEG = -1e30
MAX_HEAD_DIM = 128
MAX_GROUP = 32          # query rows of one kv head in one block (BQ)

launches = 0

_V, _I = ctypes.c_void_p, ctypes.c_int


def paged_attention_reference(q, k_pages, v_pages, k_scale, v_scale, tables,
                              lengths, *, sm_scale: Optional[float] = None):
    """Gather → dequantize (scales None: float pages) → masked softmax.
    Returns (B, KV, G, hd)."""
    b, kv, g, hd = q.shape
    ps = k_pages.shape[2]
    max_pages = tables.shape[1]
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    idx = tables.long()

    def gather(pages, scales):
        x = pages[idx].float()                         # (B, mp, KV, ps, hd)
        if scales is not None:
            x = x * scales[idx][..., None]
        return x.transpose(1, 2).reshape(b, kv, max_pages * ps, hd)

    k_all = gather(k_pages, k_scale)
    v_all = gather(v_pages, v_scale)
    s = torch.einsum("bkgh,bkth->bkgt", q.float(), k_all) * scale
    t = max_pages * ps
    mask = torch.arange(t, device=q.device)[None, :] < lengths.long()[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bkth->bkgh", p, v_all).to(q.dtype)


def _lib():
    fn = build.load("paged_attention").paged_attention
    fn.argtypes = [_V, _V, _I, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I,
                   _I, ctypes.c_float, _V]
    fn.restype = _I
    return fn


def check_pages(q, k_pages, v_pages, k_scale, v_scale, kv, hd):
    """Device, dtype, shape and contiguity checks shared by K2 and K3."""
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} must be float32 or bfloat16")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    p, _, ps, _ = k_pages.shape
    for name, t, shape, dt in (
            ("k_pages", k_pages, (p, kv, ps, hd), torch.int8),
            ("v_pages", v_pages, (p, kv, ps, hd), torch.int8),
            ("k_scale", k_scale, (p, kv, ps), torch.float32),
            ("v_scale", v_scale, (p, kv, ps), torch.float32)):
        if t is None:
            raise ValueError(f"{name} missing: the kernels take int8 pages "
                             "with per-token scales")
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.device} {t.dtype} {tuple(t.shape)}, "
                             f"expected {dev} {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    return ps


def paged_attention_cuda(q, k_pages, v_pages, k_scale, v_scale, tables,
                         lengths, *, sm_scale: Optional[float] = None):
    """Wrapper of the CUDA kernel; a CPU tensor goes to the plain version."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, k_scale,
                                         v_scale, tables, lengths,
                                         sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    b, kv, g, hd = q.shape
    if g > MAX_GROUP:
        raise ValueError(f"{g} query heads per kv head > {MAX_GROUP}")
    ps = check_pages(q, k_pages, v_pages, k_scale, v_scale, kv, hd)
    for name, t, shape in (("tables", tables, (b, tables.shape[-1])),
                           ("lengths", lengths, (b,))):
        if (t.device != q.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {shape} on "
                             f"{q.device}")
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
                k_pages.data_ptr(), v_pages.data_ptr(), k_scale.data_ptr(),
                v_scale.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                b, tables.shape[1], kv, g, hd, ps, float(scale),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def paged_attention(q, k_pages, v_pages, k_scale, v_scale, tables, lengths,
                    *, sm_scale: Optional[float] = None, impl: str = "auto"):
    """Paged decode attention; see :func:`paged_attention_reference`.
    Float pages (``k_scale`` None) take the plain version, as in the
    reference, whose kernel reads int8 pages only; ``impl='cuda'`` on them
    raises."""
    if impl == "cuda" and k_scale is None:
        raise ValueError("impl='cuda': the kernel reads int8 pages only; "
                         "float pages take the plain version")
    fn = (paged_attention_reference
          if check_impl(impl, q) == "torch" or k_scale is None
          else paged_attention_cuda)
    return fn(q, k_pages, v_pages, k_scale, v_scale, tables, lengths,
              sm_scale=sm_scale)

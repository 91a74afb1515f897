"""K2: chunked paged prefill attention — causal attention over int8 pages.

Port of the reference's ``paged_prefill_attention`` (``repro/kernels/
paged_prefill.py``). A chunk of C new tokens at positions
[q_start, q_start + C) attends over every cached token, the chunk's own
included. Layout: q (KV, C, G, hd); pages (P, KV, ps, hd) int8; scales
(P, KV, ps) f32; table (max_pages,) int32 holding at least
ceil((q_start + C) / ps) slots.

``q_start`` is a runtime integer here (the reference's is static and
recompiles per chunk); it may fall mid-page, as in speculative verify
panels. ``pages_per_step`` stays in the signature because the reference
and ``PagedPrefillCache`` carry it; it changes no result, and the kernel
does not read it: it stages 64-token tiles whatever the page size. The
kernel (``csrc/paged_common.cuh``, shared with K3) takes 64 query rows a
block and, for bf16 q, splits the kv range over several blocks when the
rows give too few (:func:`repro_torch.kernels.paged_attention.
split_plan`); ``launches`` counts wrapper calls, one per call whatever
the number of device kernels.

* :func:`paged_prefill_reference` — the plain PyTorch version.
* :func:`paged_prefill_attention` — dispatch by ``impl`` (see
  :mod:`repro_torch.kernels.ops`); :func:`paged_prefill_cuda` wraps
  ``csrc/paged_prefill.cu`` and counts ``launches``.

Float pages (scales None) take the plain version on every device, as in
the reference, whose Pallas kernel runs only for int8 pages.
:func:`paged_prefill_attention_tp` is the head-sharded tensor-parallel
wrapper, not a kernel: a rank runs K2 over its own kv heads.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ops import check_impl
from repro_torch.kernels.paged_attention import (TILE, check_head_shards,
                                                 check_pages, plan_for,
                                                 scratch)

_NEG = -1e30

launches = 0

_V, _I = ctypes.c_void_p, ctypes.c_int


def paged_prefill_reference(q, k_pages, v_pages, k_scale, v_scale, table, *,
                            q_start: int, sm_scale: Optional[float] = None):
    """Gather → dequantize (scales None: float pages) → causally-masked
    softmax. Returns (KV, C, G, hd)."""
    kv, c, g, hd = q.shape
    ps = k_pages.shape[2]
    n_pages = -(-(q_start + c) // ps)
    slots = table[:n_pages].long()
    scale = sm_scale if sm_scale is not None else hd ** -0.5

    def gather(pages, scales):
        x = pages[slots].float()                               # (np,KV,ps,hd)
        if scales is not None:
            x = x * scales[slots][..., None]
        return x.transpose(0, 1).reshape(kv, n_pages * ps, hd)

    k_all = gather(k_pages, k_scale)
    v_all = gather(v_pages, v_scale)
    s = torch.einsum("kcgh,kth->kcgt", q.float(), k_all) * scale
    t_pos = torch.arange(n_pages * ps, device=q.device)
    q_pos = q_start + torch.arange(c, device=q.device)
    mask = t_pos[None, :] <= q_pos[:, None]                    # (C, T)
    s = torch.where(mask[None, :, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("kcgt,kth->kcgh", p, v_all).to(q.dtype)


def _lib():
    fn = build.load("paged_prefill").paged_prefill
    fn.argtypes = [_V, _V, _V, _I, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I,
                   _I, ctypes.c_float, _I, _I, _V]
    fn.restype = _I
    return fn


def paged_prefill_cuda(q, k_pages, v_pages, k_scale, v_scale, table, *,
                       q_start: int, pages_per_step: int = 1,
                       sm_scale: Optional[float] = None):
    """Wrapper of the CUDA kernel; a CPU tensor goes to the plain version."""
    if q.device.type == "cpu":
        return paged_prefill_reference(q, k_pages, v_pages, k_scale, v_scale,
                                       table, q_start=q_start,
                                       sm_scale=sm_scale)
    meta.no_rule("paged_prefill_attention (K2)", q)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    kv, c, g, hd = q.shape
    ps = check_pages(q, k_pages, v_pages, k_scale, v_scale, kv, hd)
    n_pages = -(-(int(q_start) + c) // ps)
    if (table.device != q.device or table.dtype != torch.int32
            or table.ndim != 1 or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous 1-D int32 tensor on {q.device}")
    if table.shape[0] < n_pages or q_start < 0 or pages_per_step < 1:
        raise ValueError(f"table of {table.shape[0]} slots, q_start {q_start}, "
                         f"pages_per_step {pages_per_step}: need "
                         f"{n_pages} slots, q_start >= 0, pages_per_step >= 1")
    max_tiles = -(-(int(q_start) + c) // TILE)
    return _run(q, k_pages, v_pages, k_scale, v_scale, table, int(q_start),
                sm_scale, plan_for(q, kv, c * g, max_tiles))


def _run(q, k_pages, v_pages, k_scale, v_scale, table, q_start, sm_scale,
         plan):
    """Launch K2 with ``plan`` = (n_split, tiles_per_split)."""
    kv, c, g, hd = q.shape
    n_split, per = plan
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    part = scratch(kv, n_split, c * g, hd, q.device)
    rc = _lib()(q.data_ptr(), out.data_ptr(),
                0 if part is None else part.data_ptr(),
                int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
                v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                table.data_ptr(), kv, c, g, hd, k_pages.shape[2], q_start,
                float(scale), n_split, per,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, k_scale, v_scale, table, *,
                            q_start: int, pages_per_step: int = 1,
                            sm_scale: Optional[float] = None,
                            impl: str = "auto"):
    """Chunked paged prefill attention; see :func:`paged_prefill_reference`.
    Float pages (``k_scale`` None) take the plain version, as in the
    reference, whose kernel reads int8 pages only; ``impl='cuda'`` on them
    raises."""
    meta.no_rule("paged_prefill_attention (K2)", q)
    if impl == "cuda" and k_scale is None:
        raise ValueError("impl='cuda': the kernel reads int8 pages only; "
                         "float pages take the plain version")
    if check_impl(impl, q) == "torch" or k_scale is None:
        return paged_prefill_reference(q, k_pages, v_pages, k_scale, v_scale,
                                       table, q_start=q_start,
                                       sm_scale=sm_scale)
    return paged_prefill_cuda(q, k_pages, v_pages, k_scale, v_scale, table,
                              q_start=q_start, pages_per_step=pages_per_step,
                              sm_scale=sm_scale)


def paged_prefill_attention_tp(q, k_pages, v_pages, k_scale, v_scale, table,
                               *, mesh, n_kv_heads: int, q_start: int,
                               axis: str = "model", pages_per_step: int = 1,
                               sm_scale: Optional[float] = None,
                               impl: str = "auto"):
    """Head-sharded tensor-parallel chunked paged prefill, this rank's part
    (the reference's ``shard_map`` body).

    ``q``: this rank's (KV/tp, C, G, hd) queries; pages and scales: its
    shards of the pool; the block table is replicated. The rank runs the
    chunk's causal attention (:func:`paged_prefill_attention`) over its
    local heads; no KV byte crosses ranks. ``n_kv_heads`` (the model's)
    must divide over the mesh's ``axis``, else ``ValueError``.
    """
    check_head_shards(q.shape[0], k_pages.shape[1], n_kv_heads, mesh, axis)
    return paged_prefill_attention(q, k_pages, v_pages, k_scale, v_scale,
                                   table, q_start=q_start,
                                   pages_per_step=pages_per_step,
                                   sm_scale=sm_scale, impl=impl)

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

The kernel (``csrc/paged_common.cuh``, shared with K2) takes any head dim
that is a multiple of 16 up to 256 and any number of query heads per kv
head. For bf16 q it splits each sequence's kv range over several blocks
(:func:`split_plan`) and merges the splits' partials in a second launch;
f32 q takes one block per head, in the plain version's order of
operations. ``launches`` counts wrapper calls, one per call whatever the
number of device kernels.

:func:`paged_attention_tp` is the head-sharded tensor-parallel wrapper,
not a kernel: a rank runs K3 over its own kv heads of its own page shards.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ops import check_impl

_NEG = -1e30
MAX_HEAD_DIM = 256
TILE = 64               # kv tokens per tile (csrc/paged_common.cuh: BK)
MAX_WARPS = 4           # 16 query rows each (csrc/paged_common.cuh)

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
    fn.argtypes = [_V, _V, _V, _I, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I,
                   _I, _I, ctypes.c_float, _I, _I, _V]
    fn.restype = _I
    return fn


def rows_per_block(rows: int) -> int:
    """Query rows of one block: 16 per warp, 1-4 warps."""
    return 16 * min(MAX_WARPS, -(-rows // 16))


def split_plan(units: int, max_tiles: int, sms: int) -> Tuple[int, int]:
    """(n_split, tiles_per_split) for ``units`` blocks of query rows that
    each walk up to ``max_tiles`` kv tiles: split the tiles into equal runs
    so that the grid comes to about four blocks per SM, with at least one
    tile per split."""
    want = max(1, min(max_tiles, -(-4 * sms // units)))
    per = -(-max_tiles // want)
    return -(-max_tiles // per), per


def plan_for(q, n_bh: int, rows: int, max_tiles: int) -> Tuple[int, int]:
    """The kernels' split of the kv tiles for ``n_bh`` heads of ``rows``
    query rows of q's dtype on q's card: :func:`split_plan` for bf16; f32
    walks the whole sequence in one block, in the plain version's order of
    operations (``csrc/paged_common.cuh``)."""
    if q.dtype == torch.float32:
        return 1, max_tiles
    units = n_bh * -(-rows // rows_per_block(rows))
    index = (q.device.index if q.device.index is not None
             else torch.cuda.current_device())
    return split_plan(units, max_tiles, build.sm_count(index))


def scratch(n_bh: int, n_split: int, rows: int, hd: int, device):
    """The splits' partials, (m, l, acc) in f32; None for one split."""
    if n_split == 1:
        return None
    return torch.empty(n_bh * n_split * rows * (hd + 2), dtype=torch.float32,
                       device=device)


def check_pages(q, k_pages, v_pages, k_scale, v_scale, kv, hd):
    """Device, dtype, shape and contiguity checks shared by K2 and K3."""
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} must be float32 or bfloat16")
    if hd % 16 or not 16 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernels take a multiple of 16 "
                         f"from 16 to {MAX_HEAD_DIM}")
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
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async)")
    return ps


def paged_attention_cuda(q, k_pages, v_pages, k_scale, v_scale, tables,
                         lengths, *, sm_scale: Optional[float] = None):
    """Wrapper of the CUDA kernel; a CPU tensor goes to the plain version."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, k_scale,
                                         v_scale, tables, lengths,
                                         sm_scale=sm_scale)
    meta.no_rule("paged_attention (K3)", q)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    b, kv, g, hd = q.shape
    ps = check_pages(q, k_pages, v_pages, k_scale, v_scale, kv, hd)
    for name, t, shape in (("tables", tables, (b, tables.shape[-1])),
                           ("lengths", lengths, (b,))):
        if (t.device != q.device or t.dtype != torch.int32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 {shape} on "
                             f"{q.device}")
    max_tiles = -(-tables.shape[1] * ps // TILE)
    out = _run(q, k_pages, v_pages, k_scale, v_scale, tables, lengths,
               sm_scale, plan_for(q, b * kv, g, max_tiles))
    global launches
    launches += 1
    return out


def _run(q, k_pages, v_pages, k_scale, v_scale, tables, lengths, sm_scale,
         plan):
    """Launch K3 with ``plan`` = (n_split, tiles_per_split), uncounted
    (the wrapper counts; the autotune's page and chunk scorers time it)."""
    b, kv, g, hd = q.shape
    n_split, per = plan
    scale = sm_scale if sm_scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    part = scratch(b * kv, n_split, g, hd, q.device)
    rc = _lib()(q.data_ptr(), out.data_ptr(),
                0 if part is None else part.data_ptr(),
                int(q.dtype == torch.bfloat16), k_pages.data_ptr(),
                v_pages.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), b, tables.shape[1],
                kv, g, hd, k_pages.shape[2], float(scale), n_split, per,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {rc}")
    return out


def paged_attention(q, k_pages, v_pages, k_scale, v_scale, tables, lengths,
                    *, sm_scale: Optional[float] = None, impl: str = "auto"):
    """Paged decode attention; see :func:`paged_attention_reference`.
    Float pages (``k_scale`` None) take the plain version, as in the
    reference, whose kernel reads int8 pages only; ``impl='cuda'`` on them
    raises."""
    meta.no_rule("paged_attention (K3)", q)
    if impl == "cuda" and k_scale is None:
        raise ValueError("impl='cuda': the kernel reads int8 pages only; "
                         "float pages take the plain version")
    fn = (paged_attention_reference
          if check_impl(impl, q) == "torch" or k_scale is None
          else paged_attention_cuda)
    return fn(q, k_pages, v_pages, k_scale, v_scale, tables, lengths,
              sm_scale=sm_scale)


def check_head_shards(kv_local: int, pages_kv: int, n_kv_heads: int, mesh,
                      axis: str) -> None:
    """The reference's divisibility error, and this rank's heads checked
    against its page shards."""
    tp = mesh.shape[axis]
    if n_kv_heads % tp:
        raise ValueError(
            f"kv heads {n_kv_heads} not divisible by {axis}={tp}")
    if kv_local * tp != n_kv_heads or pages_kv != kv_local:
        raise ValueError(f"a rank of {axis}={tp} holds {n_kv_heads // tp} "
                         f"of {n_kv_heads} kv heads; got q with {kv_local} "
                         f"and pages with {pages_kv}")


def paged_attention_tp(q, k_pages, v_pages, k_scale, v_scale, tables,
                       lengths, *, mesh, n_kv_heads: int, axis: str = "model",
                       sm_scale: Optional[float] = None, impl: str = "auto"):
    """Head-sharded tensor-parallel paged decode attention, this rank's
    part (the reference's ``shard_map`` body).

    ``q``: this rank's (B, KV/tp, G, hd) queries; pages and scales: its
    (P, KV/tp, ps, hd) and (P, KV/tp, ps) shards of the pool; tables and
    lengths are the replicated control state. The rank runs
    :func:`paged_attention` over its local heads; no KV byte crosses
    ranks. ``n_kv_heads`` (the model's) must divide over the mesh's
    ``axis``, else ``ValueError``.
    """
    check_head_shards(q.shape[1], k_pages.shape[1], n_kv_heads, mesh, axis)
    return paged_attention(q, k_pages, v_pages, k_scale, v_scale, tables,
                           lengths, sm_scale=sm_scale, impl=impl)

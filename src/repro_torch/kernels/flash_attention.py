"""K8: dense flash attention, causal or not, with an online softmax.

Port of the reference's ``flash_attention`` (``repro/kernels/
flash_attention.py``). Layout: q, k, v (BH, S, D), batch × heads folded,
one S for all three (GQA callers repeat or fold the kv heads); returns
(BH, S, D) in q.dtype. What it computes, per query row:

* scores: the f32 product of q and k in their own dtype, times D^-0.5;
* causal: column c is visible from row r when r >= c; masked scores are
  -1e30, not -inf;
* online softmax over kv blocks, m, l and acc in f32; p is rounded to v's
  dtype before the PV product (in bf16 this decides whether the result
  stays within the reference's tolerance);
* output ``acc / max(l, 1e-30)`` in q.dtype.

kv blocks wholly above the diagonal are skipped. A row's first kv block
holds column 0, so no row ever sees only masked scores.

* :func:`flash_attention_reference` is the plain PyTorch version.
* :func:`flash_attention` dispatches by ``impl`` ('auto', 'cuda', 'torch';
  see :mod:`repro_torch.kernels.ops`); :func:`flash_attention_cuda` wraps
  ``csrc/flash_attention.cu`` and counts ``launches``.

The CUDA kernel picks its own tiles (bf16: 128 query rows × 64 kv
columns, 128 at hd 128 and 160; f32: 64 × 64) and masks a ragged last
tile. It takes a head dim that is a multiple of 8 up to
:data:`MAX_HEAD_DIM` (builds for 16, 32, 64, 128, 160 and 256; a D in
between takes the next one up, zero-filled); :func:`check_inputs` raises on
anything else. ``block_q``/``block_k`` drive the plain version, which
halves them until they divide S, as the reference does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ops import check_impl

_NEG = -1e30
MAX_HEAD_DIM = 256

launches = 0

_V, _I = ctypes.c_void_p, ctypes.c_int


def _fit_block(block: int, s: int) -> int:
    """The reference's blocking: min(block, S), halved until it divides S."""
    b = min(block, s)
    while s % b:
        b //= 2
    return b


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              block_q: int = 512, block_k: int = 512):
    """Blockwise online-softmax attention, the reference's arithmetic.

    The loop runs over kv blocks; each step updates the rows of every q
    block that the reference visits at that step (causal: those whose last
    row reaches the block's first column). A row's result therefore follows
    the reference's sequence of (m, l, acc) updates. The (S, S) score matrix
    is never built: a step holds (BH, rows, block_k) scores.
    """
    bh, s, d = q.shape
    bq, bk = _fit_block(block_q, s), _fit_block(block_k, s)
    scale = d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, s, 1), _NEG, device=q.device)
    l = torch.zeros((bh, s, 1), device=q.device)
    acc = torch.zeros((bh, s, d), device=q.device)
    rows = torch.arange(s, device=q.device)
    for j0 in range(0, s, bk):
        # causal: q blocks whose last row is at or past column j0
        r0 = (j0 // bq) * bq if causal else 0
        sc = torch.matmul(qf[:, r0:], kf[:, j0:j0 + bk].transpose(1, 2)) * scale
        if causal:
            vis = rows[r0:, None] >= rows[None, j0:j0 + bk]
            sc = torch.where(vis, sc, torch.full_like(sc, _NEG))
        m_prev = m[:, r0:]
        m_new = torch.maximum(m_prev, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m_prev - m_new)
        l[:, r0:] = l[:, r0:] * corr + p.sum(dim=-1, keepdim=True)
        m[:, r0:] = m_new
        pv = torch.matmul(p.to(v.dtype).float(), vf[:, j0:j0 + bk])
        acc[:, r0:] = acc[:, r0:] * corr + pv
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _lib():
    fn = build.load("flash_attention").flash_attention
    fn.argtypes = [_V, _V, _V, _V, _I, _I, _I, _I, _I, ctypes.c_float, _V]
    fn.restype = _I
    return fn


def smem_bytes(dtype, d: int) -> int:
    """Dynamic shared memory of one block of the kernel build that takes
    head dim ``d`` in ``dtype`` (read from the built library)."""
    fn = build.load("flash_attention").flash_attention_smem
    fn.argtypes = [_I, _I]
    fn.restype = _I
    return fn(int(dtype == torch.bfloat16), d)


def check_inputs(q, k, v) -> None:
    """Raise ValueError unless q, k, v are what the kernel takes: float32 or
    bfloat16, one dtype and device, (BH, S, D) alike, contiguous, 16-byte
    aligned, D a multiple of 8 up to MAX_HEAD_DIM."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q dtype {q.dtype} must be float32 or bfloat16")
    if q.ndim != 3:
        raise ValueError(f"q must be (BH, S, D), got {tuple(q.shape)}")
    bh, s, d = q.shape
    if d > MAX_HEAD_DIM or d % 8 or d == 0:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 "
                         f"up to {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != (bh, s, d) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {t.device} {t.dtype} {tuple(t.shape)} "
                             f"contiguous={t.is_contiguous()} at "
                             f"{t.data_ptr() % 16} mod 16, expected "
                             f"contiguous 16-byte aligned {q.device} "
                             f"{q.dtype} {(bh, s, d)}")


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """Wrapper of the CUDA kernel; a CPU tensor goes to the plain version."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal)
    meta.no_rule("flash_attention (K8)", q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    check_inputs(q, k, v)
    bh, s, d = q.shape
    out = torch.empty_like(q)
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                int(q.dtype == torch.bfloat16), bh, s, d, int(causal),
                float(d ** -0.5),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: error {rc} "
                           f"(a cudaError_t, or a tensor map's CUresult)")
    global launches
    launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, impl: str = "auto"):
    """Dense flash attention; see the module docstring. ``block_q`` and
    ``block_k`` block the plain version; the kernel picks its own tiles."""
    meta.no_rule("flash_attention (K8)", q)
    if check_impl(impl, q) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    return flash_attention_reference(q, k, v, causal=causal, block_q=block_q,
                                     block_k=block_k)

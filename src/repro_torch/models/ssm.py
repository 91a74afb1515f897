"""Mamba (S6) selective-SSM mixer: Jamba's recurrent layer.

Port of ``repro/models/ssm.py``. Prefill runs a **parallel prefix scan**
over time, split into ``cfg.ssm_seq_chunks`` segments (only when the
length divides evenly) so the (B, S, d_inner, N) scan intermediates never
exceed one segment; decode (S 1) is the single-step recurrence.

The reference's ``jax.lax.associative_scan`` has no eager PyTorch
counterpart, so each segment runs that function's recursion in plain
torch (combine adjacent pairs, scan the pairs, fill in the even
positions): log2(S) levels of a few elementwise kernels each, and the
reference's f32 products and sums in the reference's order.

The GEMMs (in/x/out projections) go through the CAMP pipeline when
quantized; ``dt_proj`` stays a float matmul, as in the reference. The
recurrence is f32 elementwise code plus one f32 contraction, which must
not run in TF32 on the card.

Under a serving mesh whose layout shards the layer ("mamba"), a rank
holds its block of d_inner of ``conv_w`` and ``A_log``: it takes its x/z
columns of the whole ``in_proj``'s output, runs the conv and the scan on
its block (state ``h`` (B, di/tp, N), window ``conv`` (B, cw-1, di/tp)),
and gathers the block for the whole ``x_proj`` and ``out_proj`` (every
value one process's).

Under the multi-pod train rules a rank holds its block of positions
(``parallel.fsdp.seq_split``): ``x_in`` (after ``in_proj``) is gathered
over ``pod`` (``collectives.gather_seq``), the conv, ``x_proj`` and the
scan run over the whole sequence, and the rank's block of ``y`` meets
its own ``z`` and goes into ``out_proj``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import linear, refuse_tf32
from repro_torch.parallel.collectives import all_gather_last, gather_seq
from repro_torch.parallel.fsdp import seq_split
from repro_torch.parallel.sharding import sharded, tp_mesh


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """The reference's shapes and scales, drawn from ``gen``."""
    d, di, n, r, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                       cfg.dt_rank, cfg.ssm_conv_dim)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5),
        "conv_w": normal((cw, di), cw ** -0.5),
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "x_proj": normal((di, r + 2 * n), di ** -0.5),
        "dt_proj": normal((r, di), r ** -0.5),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),
        "A_log": torch.log(a.repeat(di, 1)),
        "D": torch.ones(di, dtype=torch.float32, device=device),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. x: (B, S, di), w: (cw, di); taps
    multiplied and summed left to right in x's dtype, then ``b`` added.

    ``prev``: (B, cw-1, di) trailing inputs of the previous segment/step.
    Returns (y, new_prev).
    """
    cw, s = w.shape[0], x.shape[1]
    if prev is None:
        prev = x.new_zeros(x.shape[0], cw - 1, x.shape[2])
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + s] * w[i] for i in range(cw))
    return y + b, xp[:, xp.shape[1] - (cw - 1):]


def _combine(left, right):
    """The scan's operator: (a_l, b_l) ∘ (a_r, b_r) = (a_l a_r,
    a_r b_l + b_r)."""
    (al, bl), (ar, br) = left, right
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Even positions from ``even``, odd ones from ``odd``, along axis 1."""
    out = even.new_empty(even.shape[0], even.shape[1] + odd.shape[1],
                         *even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of :func:`_combine` over axis 1, by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan those, then
    fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _prefix_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                 (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        odd_head = (odd[0][:, :-1], odd[1][:, :-1])
    else:
        odd_head = odd
    even = _combine(odd_head, (a[:, 2::2], b[:, 2::2]))
    even = (torch.cat([a[:, :1], even[0]], dim=1),
            torch.cat([b[:, :1], even[1]], dim=1))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _ssm_scan_segment(a: torch.Tensor, bu: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t ⊙ h_{t-1} + bu_t over axis 1. a, bu: (B, Sseg, di, N) f32.

    Returns (h_all, h_last). Parallel prefix (the reference's associative
    scan, in its order).
    """
    a_cum, b_cum = _prefix_scan(a, bu)
    h_all = b_cum + a_cum * h0[:, None]
    return h_all, h_all[:, -1].clone()


def mamba_mixer(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                cache: Optional[dict] = None, qmode: str = "none",
                impl: str = "auto"):
    """x: (B, S, D) → (y, new_cache). cache = {'h': (B, di, N) f32,
    'conv': (B, cw-1, di)} for decode/prefill continuation."""
    refuse_tf32(x, "the Mamba scan")
    b, s, _ = x.shape
    di, n, r = cfg.d_inner, cfg.ssm_state_dim, cfg.dt_rank
    f32 = torch.float32

    own = slice(0, di)                  # this rank's block of d_inner
    mesh, tp = tp_mesh() if sharded("mamba") else (None, 1)
    if mesh is not None:
        blk = di // tp
        idx = mesh.coords["model"]
        own = slice(idx * blk, (idx + 1) * blk)
        di = blk

    xz = linear(x, p["in_proj"], qmode=qmode, impl=impl)
    x_in, z = xz[..., own], xz[..., cfg.d_inner:][..., own]
    split = seq_split() if cache is None else None
    if split is not None:         # the whole sequence of this rank's rows
        x_in = gather_seq(x_in, split.mesh, split.seq_axes)

    prev_conv = cache["conv"] if cache is not None else None
    x_c, new_conv = _causal_conv(x_in, p["conv_w"], p["conv_b"][own],
                                 prev_conv)
    x_c = F.silu(x_c.float()).to(x.dtype)

    x_all = x_c if mesh is None else all_gather_last(x_c, mesh)
    dbc = linear(x_all, p["x_proj"], qmode=qmode, impl=impl)
    dt, bm, cm = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    dt = linear(dt, p["dt_proj"])[..., own].float() \
        + p["dt_bias"][own].float()
    dt = torch.logaddexp(dt, torch.zeros((), dtype=f32, device=x.device))

    a_mat = -torch.exp(p["A_log"])                                 # (di, N)
    # decay and driving terms, f32: (B, S, di, N)
    dec = (dt[..., None] * a_mat).exp_()
    bu = (dt * x_c.float())[..., None] * bm.float()[:, :, None, :]

    h = (cache["h"] if cache is not None
         else torch.zeros(b, di, n, dtype=f32, device=x.device))
    s = x_in.shape[1]
    chunks = cfg.ssm_seq_chunks
    nseg = chunks if s > chunks and s % chunks == 0 else 1
    seg = s // nseg
    cmf = cm.float()
    ys = []
    for i in range(nseg):
        sl = slice(i * seg, (i + 1) * seg)
        h_all, h = _ssm_scan_segment(dec[:, sl], bu[:, sl], h)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all, cmf[:, sl]))
    y = torch.cat(ys, dim=1)
    y = y + p["D"][own].float() * x_c.float()
    if split is not None:                      # this rank's positions
        blk = z.shape[1]
        y = y[:, split.seq_index * blk:(split.seq_index + 1) * blk]
    y = (y * F.silu(z.float())).to(x.dtype)

    if mesh is not None:                       # out_proj is whole
        y = all_gather_last(y, mesh)
    out = linear(y, p["out_proj"], qmode=qmode, impl=impl)
    new_cache = {"h": h, "conv": new_conv} if cache is not None else None
    return out, new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    return {
        "h": torch.zeros(batch, cfg.d_inner, cfg.ssm_state_dim,
                         dtype=torch.float32, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv_dim - 1, cfg.d_inner,
                            dtype=dtype, device=device),
    }

"""RWKV6 "Finch" mixer: data-dependent decay linear attention, chunkwise.

Port of ``repro/models/rwkv.py``. The WKV6 recurrence per head (state
S ∈ R^{hd_k × hd_v}):

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ · (S_{t-1} + diag(u) k_t v_tᵀ)

runs in the reference's **chunkwise-parallel** form (so its f32 rounding
follows the reference's): intra-chunk work is batched einsums over every
chunk at once; the cross-chunk state propagation is a loop over chunks
that emits the state *before* each chunk. Log-decays are clamped to
[-LW_MAX, -1e-4], which bounds the factorised intra-chunk exponents by
C·LW_MAX (80 < 88 = log(f32 max) at C 32). Decode (S 1) is one step.

The projections go through the CAMP pipeline when quantized; the WKV
contractions are f32 and must not run in TF32 on the card.

Under a serving mesh whose layout shards the time mix ("rwkv_tm"), a rank
holds the wr/wk/wv/wg columns of its heads: it runs the WKV state ``s``
(B, H/tp, hd, hd) and the per-head norm of its own heads, and gathers y
for the whole ``out_proj`` (every value one process's). Sharding the
channel mix ("rwkv_cm"), it holds the w_gate and receptance w_up columns
and w_down's rows: relu² of its d_ff block, the down projection
row-parallel (``modules.row_linear``), the receptance gathered.

Under the multi-pod train rules a rank holds its block of positions
(``parallel.fsdp.seq_split``): both token shifts take the previous
rank's last position (``collectives.halo_prev``), the time mix gathers
r, k, v and the log decays over ``pod`` (``collectives.gather_seq``),
runs the WKV over the whole sequence from a zero state, as the
reference's ``seq`` rule keeps it, and keeps its own block of y.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (group_norm_heads, linear, refuse_tf32,
                                        row_linear)
from repro_torch.parallel.collectives import (all_gather_last, gather_seq,
                                              halo_prev)
from repro_torch.parallel.fsdp import seq_split
from repro_torch.parallel.sharding import sharded, tp_mesh

LW_MAX = 2.5
_MIX = ("r", "w", "k", "v", "g")


def init_rwkv_time_mix(gen: torch.Generator, cfg: ModelConfig, dtype,
                       device) -> dict:
    """The reference's shapes and scales, drawn from ``gen``."""
    d, hd, r = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_lora_r
    h = d // hd
    m = len(_MIX)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    sc = d ** -0.5
    return {
        "wr": normal((d, d), sc), "wk": normal((d, d), sc),
        "wv": normal((d, d), sc), "wg": normal((d, d), sc),
        "out_proj": normal((d, d), sc),
        "time_maa_x": full((d,), 0.0),
        "time_maa": full((m, d), 0.0),
        "time_maa_w1": normal((d, m * 32), sc),
        "time_maa_w2": normal((m, 32, d), 0.03),
        "w0": full((d,), 0.5),                         # base log-log decay
        "w_lora_a": normal((d, r), sc),
        "w_lora_b": normal((r, d), 0.03),
        "u": normal((h, hd), 0.1),
        "g_norm_scale": full((h, hd), 1.0),
        "g_norm_bias": full((h, hd), 0.0),
    }


def _prev_token(x, cache, split):
    """The token shift's input before x's first position (B, 1, D): the
    cache's last token, the previous rank's last position under a
    sequence split (``collectives.halo_prev``), else zeros."""
    if cache is not None:
        return cache["x_prev"][:, None]
    if split is not None:
        return halo_prev(x, split.mesh, split.seq_axes)
    return x.new_zeros(x.shape[0], 1, x.shape[2])


def _ddlerp(p, x, x_prev):
    """RWKV6 data-dependent token-shift interpolation for the 5 streams."""
    sx = x_prev - x                                            # (B,S,D)
    xxx = x + sx * p["time_maa_x"].to(x.dtype)
    lora = torch.tanh(linear(xxx, p["time_maa_w1"]))           # (B,S,5*32)
    b, s, _ = lora.shape
    lora = lora.reshape(b, s, len(_MIX), 32)
    dd = torch.einsum("bsmr,mrd->bsmd", lora, p["time_maa_w2"].to(x.dtype))
    return {name: x + sx * (p["time_maa"][i].to(x.dtype) + dd[:, :, i])
            for i, name in enumerate(_MIX)}


def _wkv6_chunked(r, k, v, lw, u, s0, chunk: int):
    """Chunkwise-parallel WKV6. r, k, v, lw: (B, S, H, hd) f32 (lw = log
    decay ≤ 0), u: (H, hd), s0: (B, H, hd, hd). Returns (y (B, S, H, hd),
    s_final)."""
    b, s, h, hd = r.shape
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rs, ks_, vs, lws = (t.reshape(b, nc, chunk, h, hd) for t in (r, k, v, lw))

    cl = torch.cumsum(lws, dim=2)                              # inclusive Σlw
    cl_prev = cl - lws                                         # exclusive
    CL = cl[:, :, -1:]                                         # (B,nc,1,H,hd)

    q_t = rs * torch.exp(cl_prev - CL)                         # ≤ e^{|CL|}
    k_t = ks_ * torch.exp(CL - cl)                             # ≤ 1
    # strictly causal intra-chunk attention matrix (B, nc, H, C, C)
    a = torch.einsum("bnthd,bnshd->bnhts", q_t, k_t)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), diagonal=-1)
    a = torch.where(tri, a, 0.0)
    y_intra = torch.einsum("bnhts,bnshd->bnthd", a, vs)
    # diagonal (current-token bonus) term
    y_diag = torch.einsum("bnthd,bnthd->bnth", rs * u, ks_)
    y_intra = y_intra + y_diag[..., None] * vs

    # cross-chunk: per-chunk state inputs and decays
    upd = torch.einsum("bnshd,bnshe->bnhde", k_t, vs)          # Σ k̃ ⊗ v
    dec = torch.exp(CL[:, :, 0])                               # (B,nc,H,hd)
    starts = []
    st = s0
    for i in range(nc):
        starts.append(st)                          # the state *before* chunk i
        st = st * dec[:, i, ..., None] + upd[:, i]
    s_starts = torch.stack(starts, dim=1)                      # (B,nc,H,hd,hd)

    q_c = rs * torch.exp(cl_prev)                       # from chunk start
    y_cross = torch.einsum("bnthd,bnhde->bnthe", q_c, s_starts)
    return (y_intra + y_cross).reshape(b, s, h, hd), st


def _wkv6_step(r, k, v, lw, u, s0):
    """Single-token WKV6 (decode). r, k, v, lw: (B, 1, H, hd) f32."""
    r0, k0, v0, lw0 = (t[:, 0] for t in (r, k, v, lw))
    y = torch.einsum("bhd,bhde->bhe", r0, s0) \
        + torch.einsum("bhd,bhd->bh", r0 * u, k0)[..., None] * v0
    s1 = s0 * torch.exp(lw0)[..., None] + k0[..., None] * v0[:, :, None]
    return y[:, None], s1


def rwkv_time_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  cache: Optional[dict] = None, qmode: str = "none",
                  impl: str = "auto"):
    """x: (B, S, D) → (y, new_cache). cache = {'s': (B, H, hd, hd) f32,
    'x_prev': (B, D)}: the state and the mixer's last input token."""
    refuse_tf32(x, "the WKV recurrence")
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    heads = slice(0, h)                      # this rank's heads
    mesh, tp = tp_mesh() if sharded("rwkv_tm") else (None, 1)
    if mesh is not None:
        h //= tp
        heads = slice(mesh.coords["model"] * h, (mesh.coords["model"] + 1) * h)
    cols = slice(heads.start * hd, heads.stop * hd)
    split = seq_split() if cache is None else None

    x_prev_tok = _prev_token(x, cache, split)
    x_shift = torch.cat([x_prev_tok, x[:, :-1]], dim=1)
    mixed = _ddlerp(p, x, x_shift)

    def proj(name, w):
        return linear(mixed[name], p[w], qmode=qmode, impl=impl)
    r, k, v = proj("r", "wr"), proj("k", "wk"), proj("v", "wv")
    g = F.silu(proj("g", "wg").float()).to(x.dtype)

    lw_raw = p["w0"].float() + torch.tanh(
        linear(mixed["w"], p["w_lora_a"]).float()) @ p["w_lora_b"].float()
    lw = -torch.clamp(torch.exp(lw_raw[..., cols]), 1e-4, LW_MAX)  # ≤ 0

    rh, kh, vh = (t.reshape(b, s, h, hd).float() for t in (r, k, v))
    lwh = lw.reshape(b, s, h, hd)
    if split is not None:     # the WKV over the whole sequence of the rows
        whole = gather_seq(torch.stack([rh, kh, vh, lwh], dim=-1),
                           split.mesh, split.seq_axes)
        rh, kh, vh, lwh = whole.unbind(dim=-1)
    s0 = (cache["s"] if cache is not None
          else x.new_zeros(b, h, hd, hd, dtype=torch.float32))
    u = p["u"][heads].float()

    if s == 1:
        y, s_fin = _wkv6_step(rh, kh, vh, lwh, u, s0)
    else:
        s_all = rh.shape[1]
        chunk = min(cfg.rwkv_chunk, s_all)
        while s_all % chunk:
            chunk -= 1
        y, s_fin = _wkv6_chunked(rh, kh, vh, lwh, u, s0, chunk)
        if split is not None:                  # this rank's positions
            y = y[:, split.seq_index * s:(split.seq_index + 1) * s]

    y = group_norm_heads(y, p["g_norm_scale"][heads], p["g_norm_bias"][heads],
                         cfg.norm_eps)
    y = y.reshape(b, s, h * hd).to(x.dtype) * g
    if mesh is not None:                       # out_proj is whole
        y = all_gather_last(y, mesh)
    out = linear(y, p["out_proj"], qmode=qmode, impl=impl)
    new_cache = None
    if cache is not None:
        new_cache = {"s": s_fin, "x_prev": x[:, -1]}
    return out, new_cache


def wkv6_sequential_ref(r, k, v, lw, u, s0):
    """Sequential oracle for the chunked WKV6 (testing only)."""
    ys = []
    st = s0
    for t in range(r.shape[1]):
        y = torch.einsum("bhd,bhde->bhe", r[:, t], st) \
            + torch.einsum("bhd,bhd->bh", r[:, t] * u, k[:, t])[..., None] \
            * v[:, t]
        st = st * torch.exp(lw[:, t])[..., None] \
            + k[:, t][..., None] * v[:, t][:, :, None]
        ys.append(y)
    return torch.stack(ys, dim=1), st


# ---------------------------------------------------------------------------
# RWKV channel mix (the FFN analogue)
# ---------------------------------------------------------------------------
def init_rwkv_channel_mix(gen: torch.Generator, cfg: ModelConfig, dtype,
                          device) -> dict:
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)

    return {
        "maa_k": torch.zeros(d, dtype=dtype, device=device),
        "maa_r": torch.zeros(d, dtype=dtype, device=device),
        "w_gate": normal((d, f), d ** -0.5),
        "w_down": normal((f, d), f ** -0.5),
        "w_up": normal((d, d), d ** -0.5),                     # receptance
    }


def rwkv_channel_mix(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                     cache: Optional[dict] = None, qmode: str = "none",
                     impl: str = "auto"):
    """x: (B, S, D) → (y, new_cache); cache = {'x_prev': (B, D)}."""
    x_prev_tok = _prev_token(x, cache,
                             seq_split() if cache is None else None)
    sx = torch.cat([x_prev_tok, x[:, :-1]], dim=1) - x
    xk = x + sx * p["maa_k"].to(x.dtype)
    xr = x + sx * p["maa_r"].to(x.dtype)
    k = linear(xk, p["w_gate"], qmode=qmode, impl=impl)
    k = F.relu(k.float()).square().to(x.dtype)
    r = linear(xr, p["w_up"], qmode=qmode, impl=impl)
    if sharded("rwkv_cm"):          # this rank's d_ff block, its r columns
        v = row_linear(k, p["w_down"], qmode=qmode, impl=impl)
        r = all_gather_last(r, tp_mesh()[0])
    else:
        v = linear(k, p["w_down"], qmode=qmode, impl=impl)
    rgate = torch.sigmoid(r.float())
    y = (rgate * v.float()).to(x.dtype)
    new_cache = {"x_prev": x[:, -1]} if cache is not None else None
    return y, new_cache

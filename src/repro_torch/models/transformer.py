"""Decoder-LM assembly: embeddings → N blocks (attention + gated MLP) → head.

Port of ``repro/models/transformer.py`` for all-attention dense decoders
(the qwen2 family on the serving path), with the dense KV caches of
:func:`init_caches`. MoE, SSM and RWKV layers come in later slices and
raise here. :func:`quantize_params` converts every GEMM
weight to a :class:`~repro_torch.core.quant.QuantizedTensor`; the same
forward then routes through the CAMP kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import gated_mlp, linear, rms_norm


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_supported(cfg: ModelConfig) -> None:
    for i in range(cfg.n_layers):
        if cfg.mixer_of(i) != "attn" or cfg.ffn_of(i) != "dense":
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is {cfg.mixer_of(i)}/{cfg.ffn_of(i)};"
                " the port runs attention + dense FFN layers only so far")
    if cfg.embedding_inputs:
        raise NotImplementedError(f"{cfg.name}: embedding inputs not ported")


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random weights with the reference's shapes and scales.

    ``generator`` (default: seed 0 on ``device``) must live on ``device``.
    """
    _check_supported(cfg)
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dt)

    params: dict = {"embedding": normal((cfg.vocab_size, d), 0.02),
                    "final_norm": torch.ones(d, dtype=dt, device=device),
                    "layers": []}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), 0.02)
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": torch.ones(d, dtype=dt, device=device),
            "ln2": torch.ones(d, dtype=dt, device=device),
            "attn": attn_mod.init_attention(gen, cfg, dt, device),
            "mlp": {"w_gate": normal((d, f), d ** -0.5),
                    "w_up": normal((d, f), d ** -0.5),
                    "w_down": normal((f, d), f ** -0.5)},
        })
    return params


def _block(lp: dict, cfg: ModelConfig, h: torch.Tensor,
           positions: torch.Tensor, cache, cache_pos, qmode: str, impl: str):
    """One residual block → (h, new_cache)."""
    y, new_cache = attn_mod.attention(
        lp["attn"], cfg, rms_norm(h, lp["ln1"], cfg.norm_eps), positions,
        cache=cache, cache_pos=cache_pos, qmode=qmode, impl=impl)
    h = h + y
    h = h + gated_mlp(rms_norm(h, lp["ln2"], cfg.norm_eps), lp["mlp"],
                      qmode=qmode, impl=impl)
    return h, new_cache


def forward(params: dict, cfg: ModelConfig, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            caches: Optional[list] = None, cache_pos: Optional[int] = None,
            qmode: Optional[str] = None, last_logits_only: bool = False,
            return_hidden: bool = False, impl: str = "auto"):
    """inputs: int tokens (B, S) → (logits, new_caches).

    ``caches``: per layer ``{"attn": DenseKVCache | PagedPrefillCache |
    PagedDecodeCache}`` or None (full causal attention). ``cache_pos``: the
    position of a one-token decode step over DenseKVCaches; positions then
    default to ``cache_pos + arange(S)``. ``last_logits_only``: the head at
    the final position only. ``return_hidden``: the final hidden states
    instead of logits. ``impl`` selects kernels or plain versions (see
    :mod:`repro_torch.kernels.ops`).
    """
    qmode = cfg.qmode if qmode is None else qmode
    b, s = inputs.shape[:2]
    if positions is None:
        base = torch.arange(s, device=inputs.device)
        if cache_pos is not None:
            base = base + cache_pos
        positions = base.expand(b, s)
    # token ids past the vocabulary take its last row, as the reference's
    # gather clamps them (a narrow-vocabulary draft model reads the
    # target's tokens)
    h = params["embedding"][inputs.clamp(max=cfg.vocab_size - 1)
                            ].to(dtype_of(cfg))
    new_caches = [] if caches is not None else None
    for i, lp in enumerate(params["layers"]):
        cache_i = caches[i]["attn"] if caches is not None else None
        h, c_new = _block(lp, cfg, h, positions, cache_i, cache_pos, qmode,
                          impl)
        if new_caches is not None:
            new_caches.append({"attn": c_new})
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, new_caches
    if last_logits_only:
        h = h[:, -1:]
    head = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    logits = linear(h, head, qmode="none" if cfg.tie_embeddings else qmode,
                    impl=impl)
    return logits, new_caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                kv_dtype: Optional[str] = None, device=None) -> list:
    """Per-layer dense decode caches ``[{"attn": DenseKVCache}, ...]``;
    ``kv_dtype='int8'`` quantizes the slabs with per-page scales. Recurrent
    mixers' state caches come with those mixers."""
    _check_supported(cfg)
    device = resolve_device(device)
    return [{"attn": attn_mod.init_cache(cfg, batch, max_len, dtype_of(cfg),
                                         kv_dtype=kv_dtype, device=device)}
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# PTQ: CAMP-quantize every GEMM weight in a params tree
# ---------------------------------------------------------------------------
_QUANT_KEYS = {"wq", "wk", "wv", "wo", "wr", "wg", "w_gate", "w_up", "w_down",
               "in_proj", "out_proj", "x_proj", "lm_head"}
_MIN_K = 64   # skip tiny projections — not worth the integer path


def quantize_params(params: dict, cfg: ModelConfig, qmode: str) -> dict:
    """Post-training quantization: GEMM weights → QuantizedTensor."""
    from repro_torch.core.camp import prepare_weight
    if qmode == "none":
        return params

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if (key in _QUANT_KEYS and isinstance(tree, torch.Tensor)
                and tree.ndim == 2 and tree.shape[0] >= _MIN_K
                and tree.shape[0] % 2 == 0):
            return prepare_weight(tree, qmode)
        return tree

    return walk(params)

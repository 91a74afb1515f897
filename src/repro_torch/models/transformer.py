"""Decoder-LM assembly: embeddings → N blocks (attention + FFN) → head.

Port of ``repro/models/transformer.py`` for attention decoders whose FFN
is dense (gated MLP) or a mixture of experts (:mod:`repro_torch.models.
moe`), per layer as ``cfg.ffn_of`` says, with the dense KV caches of
:func:`init_caches`. SSM and RWKV layers and embedding inputs come in
later slices and raise here. :func:`quantize_params` converts every GEMM
weight to a :class:`~repro_torch.core.quant.QuantizedTensor` (expert
stacks per expert); the same forward then routes through the CAMP
kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import gated_mlp, linear, rms_norm

MOE_AUX_COEF = 0.01   # weight of the MoE aux loss in training (not ported)


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(gen, device, dtype, shape, scale) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def _check_supported(cfg: ModelConfig) -> None:
    for i in range(cfg.n_layers):
        if cfg.mixer_of(i) != "attn" or cfg.ffn_of(i) not in ("dense",
                                                               "moe"):
            raise NotImplementedError(
                f"{cfg.name}: layer {i} is {cfg.mixer_of(i)}/{cfg.ffn_of(i)};"
                " the port runs attention layers with dense or MoE FFNs "
                "only so far")
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
    dt, d, v = dtype_of(cfg), cfg.d_model, cfg.vocab_size
    params: dict = {"embedding": _normal(gen, device, dt, (v, d), 0.02),
                    "final_norm": torch.ones(d, dtype=dt, device=device),
                    "layers": []}
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, device, dt, (d, v), 0.02)
    for i in range(cfg.n_layers):
        params["layers"].append(init_layer(cfg, i, gen, device))
    return params


def init_layer(cfg: ModelConfig, i: int, gen: torch.Generator,
               device) -> dict:
    """Layer ``i``'s random weights, drawn from ``gen`` on ``device``: a
    model too large to hold in bf16 beside its quantized copy is built and
    quantized one layer at a time."""
    dt = dtype_of(cfg)
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return _normal(gen, device, dt, shape, scale)

    layer = {"ln1": torch.ones(d, dtype=dt, device=device),
             "ln2": torch.ones(d, dtype=dt, device=device),
             "attn": attn_mod.init_attention(gen, cfg, dt, device)}
    if cfg.ffn_of(i) == "moe":
        layer["moe"] = moe_mod.init_moe(gen, cfg, dt, device)
    else:
        layer["mlp"] = {"w_gate": normal((d, f), d ** -0.5),
                        "w_up": normal((d, f), d ** -0.5),
                        "w_down": normal((f, d), f ** -0.5)}
    return layer


def _block(lp: dict, cfg: ModelConfig, i: int, h: torch.Tensor,
           positions: torch.Tensor, cache, cache_pos, qmode: str, impl: str):
    """One residual block → (h, new_cache, aux); aux is None for a dense
    FFN."""
    y, new_cache = attn_mod.attention(
        lp["attn"], cfg, rms_norm(h, lp["ln1"], cfg.norm_eps), positions,
        cache=cache, cache_pos=cache_pos, qmode=qmode, impl=impl)
    h = h + y
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    aux = None
    if cfg.ffn_of(i) == "moe":
        y, aux = moe_mod.moe_ffn(lp["moe"], cfg, hn, qmode=qmode, impl=impl)
    else:
        y = gated_mlp(hn, lp["mlp"], qmode=qmode, impl=impl)
    return h + y, new_cache, aux


def forward(params: dict, cfg: ModelConfig, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            caches: Optional[list] = None, cache_pos: Optional[int] = None,
            qmode: Optional[str] = None, last_logits_only: bool = False,
            return_hidden: bool = False, impl: str = "auto"):
    """inputs: int tokens (B, S) → (logits, new_caches, aux).

    ``caches``: per layer ``{"attn": DenseKVCache | PagedPrefillCache |
    PagedDecodeCache}`` or None (full causal attention). ``cache_pos``: the
    position of a one-token decode step over DenseKVCaches; positions then
    default to ``cache_pos + arange(S)``. ``last_logits_only``: the head at
    the final position only. ``return_hidden``: the final hidden states
    instead of logits. ``impl`` selects kernels or plain versions (see
    :mod:`repro_torch.kernels.ops`). ``aux``: the MoE layers' load-balance
    losses summed (f32 scalar; zero without MoE layers).
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
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i, lp in enumerate(params["layers"]):
        cache_i = caches[i]["attn"] if caches is not None else None
        h, c_new, aux = _block(lp, cfg, i, h, positions, cache_i, cache_pos,
                               qmode, impl)
        if new_caches is not None:
            new_caches.append({"attn": c_new})
        if aux is not None:
            aux_total = aux_total + aux
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, new_caches, aux_total
    if last_logits_only:
        h = h[:, -1:]
    head = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    logits = linear(h, head, qmode="none" if cfg.tie_embeddings else qmode,
                    impl=impl)
    return logits, new_caches, aux_total


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
    """Post-training quantization: GEMM weights → QuantizedTensor; the
    (E, K, N) stacks under ``experts`` per expert, the f32 router kept.
    Any subtree of a params tree (one layer, say) quantizes alike."""
    from repro_torch.core.camp import prepare_weight, weight_bits
    if qmode == "none":
        return params

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        if not (path and path[-1] in _QUANT_KEYS
                and isinstance(tree, torch.Tensor)):
            return tree
        if ("experts" in path and tree.ndim == 3
                and tree.shape[1] % 2 == 0):
            return moe_mod.quantize_expert_weight(tree, weight_bits(qmode))
        if (tree.ndim == 2 and tree.shape[0] >= _MIN_K
                and tree.shape[0] % 2 == 0):
            return prepare_weight(tree, qmode)
        return tree

    return walk(params)

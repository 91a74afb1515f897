"""Decoder-LM assembly: embeddings → N blocks (mixer + FFN) → head.

Port of ``repro/models/transformer.py``. One code path drives all ten
architectures through ``ModelConfig``: the mixer of each layer is
attention, Mamba (:mod:`repro_torch.models.ssm`) or RWKV6 time mix
(:mod:`repro_torch.models.rwkv`), and its FFN a gated MLP, a mixture of
experts (:mod:`repro_torch.models.moe`) or the RWKV channel mix, as
``cfg.mixer_of`` / ``cfg.ffn_of`` say. Models with ``embedding_inputs``
take float (B, S, D) embeddings in place of token ids.
:func:`quantize_params` converts every GEMM weight to a
:class:`~repro_torch.core.quant.QuantizedTensor` (expert stacks per
expert); the same forward then routes through the CAMP kernels.
:func:`loss_fn` is the training loss: the forward to the final hidden
states (one recomputed checkpoint per block when ``cfg.remat``), the
streamed cross entropy over the head, and the MoE aux loss.

Under a serving mesh (:mod:`repro_torch.parallel.sharding`; the paged
engine's or the dense slab's) whose layout shards the vocabulary
("vocab" → model), a rank holds its block of embedding rows: the lookup
takes the ids in its block and an all-reduce sums the ranks' rows (exact:
one addend is not zero), and the head (tied, or an untied ``lm_head``
holding its block of columns) computes this rank's logit columns and
gathers them in rank order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import (chunked_xent, gated_mlp, linear,
                                        rms_norm)
from repro_torch.parallel.collectives import all_gather_last, psum
from repro_torch.parallel.fsdp import seq_split, whole
from repro_torch.parallel.sharding import (RankShards, shard_params, sharded,
                                           tp_mesh)

MOE_AUX_COEF = 0.01   # weight of the MoE aux loss in training


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _normal(gen, device, dtype, shape, scale) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator] = None,
                device=None) -> dict:
    """Random weights with the reference's shapes and scales.

    ``generator`` (default: seed 0 on ``device``) must live on ``device``.
    """
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


def init_quantized_params(cfg: ModelConfig, qmode: str, *,
                          generator: Optional[torch.Generator] = None,
                          device=None, mesh=None) -> dict:
    """``quantize_params(init_params(cfg, generator=...), cfg, qmode)``
    built one layer at a time: the same draws from one generator in the
    same order (embedding, head, then each layer), each layer quantized
    before the next is drawn, so at most one layer is ever held in bf16
    (full-width jamba-v0.1-52b is ~103 GB in bf16, ~52 GB at int8).

    With ``mesh`` (a serving mesh): this rank's
    :class:`~repro_torch.parallel.sharding.RankShards`, each part (dense
    and MoE layers alike) sharded (:func:`~repro_torch.parallel.sharding.
    shard_params`) before the next is drawn, so a rank holds one whole
    layer at most besides its shards.
    """
    device = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)

    def part(tree):
        tree = quantize_params(tree, cfg, qmode)
        return tree if mesh is None else shard_params(tree, mesh, cfg)
    params = part(init_params(dataclasses.replace(cfg, n_layers=0),
                              generator=gen, device=device))
    layers = [part({"layers": [init_layer(cfg, i, gen, device)]})
              for i in range(cfg.n_layers)]
    params["layers"] = [tree["layers"][0] for tree in layers]
    if mesh is None:
        return params
    return RankShards(params, params.layout.union(
        *(tree.layout for tree in layers)), params.whole_bytes
        + sum(tree.whole_bytes for tree in layers))


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
             "ln2": torch.ones(d, dtype=dt, device=device)}
    mixer = cfg.mixer_of(i)
    if mixer == "attn":
        layer["attn"] = attn_mod.init_attention(gen, cfg, dt, device)
    elif mixer == "mamba":
        layer["mamba"] = ssm_mod.init_mamba(gen, cfg, dt, device)
    elif mixer == "rwkv":
        layer["rwkv_tm"] = rwkv_mod.init_rwkv_time_mix(gen, cfg, dt, device)
    else:
        raise ValueError(mixer)
    ffn = cfg.ffn_of(i)
    if ffn == "moe":
        layer["moe"] = moe_mod.init_moe(gen, cfg, dt, device)
    elif ffn == "rwkv_cmix":
        layer["rwkv_cm"] = rwkv_mod.init_rwkv_channel_mix(gen, cfg, dt,
                                                          device)
    else:
        layer["mlp"] = {"w_gate": normal((d, f), d ** -0.5),
                        "w_up": normal((d, f), d ** -0.5),
                        "w_down": normal((f, d), f ** -0.5)}
    return layer


def _block(lp: dict, cfg: ModelConfig, i: int, h: torch.Tensor,
           positions: torch.Tensor, cache: Optional[dict], cache_pos,
           qmode: str, impl: str):
    """One residual block → (h, new_cache, aux). ``cache``: the layer's
    dict (``attn`` / ``mamba`` / ``rwkv_tm``, and ``rwkv_cm`` beside a
    channel mix) or None; aux is None unless the FFN is MoE. Under a
    sharded train step ``lp`` holds this rank's blocks, gathered here
    (:func:`~repro_torch.parallel.fsdp.whole`), inside the block's
    checkpoint."""
    lp = whole(lp, ("layers", i))
    hn = rms_norm(h, lp["ln1"], cfg.norm_eps)
    mixer = cfg.mixer_of(i)
    key = {"attn": "attn", "mamba": "mamba", "rwkv": "rwkv_tm"}[mixer]
    c_in = None if cache is None else cache.get(key)
    if mixer == "attn":
        y, c_new = attn_mod.attention(lp["attn"], cfg, hn, positions,
                                      cache=c_in, cache_pos=cache_pos,
                                      qmode=qmode, impl=impl)
    elif mixer == "mamba":
        y, c_new = ssm_mod.mamba_mixer(lp["mamba"], cfg, hn, cache=c_in,
                                       qmode=qmode, impl=impl)
    else:
        y, c_new = rwkv_mod.rwkv_time_mix(lp["rwkv_tm"], cfg, hn, cache=c_in,
                                          qmode=qmode, impl=impl)
    c_out = None if c_new is None else {key: c_new}
    h = h + y
    hn = rms_norm(h, lp["ln2"], cfg.norm_eps)
    aux = None
    ffn = cfg.ffn_of(i)
    if ffn == "moe":
        y, aux = moe_mod.moe_ffn(lp["moe"], cfg, hn, qmode=qmode, impl=impl)
    elif ffn == "rwkv_cmix":
        y, c_cm = rwkv_mod.rwkv_channel_mix(
            lp["rwkv_cm"], cfg, hn,
            cache=None if cache is None else cache.get("rwkv_cm"),
            qmode=qmode, impl=impl)
        if c_cm is not None:
            c_out = {**(c_out or {}), "rwkv_cm": c_cm}
    else:
        y = gated_mlp(hn, lp["mlp"], qmode=qmode, impl=impl)
    return h + y, c_out, aux


def forward(params: dict, cfg: ModelConfig, inputs: torch.Tensor,
            positions: Optional[torch.Tensor] = None, *,
            caches: Optional[list] = None, cache_pos: Optional[int] = None,
            qmode: Optional[str] = None, last_logits_only: bool = False,
            return_hidden: bool = False, impl: str = "auto"):
    """inputs: int tokens (B, S), or float embeddings (B, S, D) when
    ``cfg.embedding_inputs`` → (logits, new_caches, aux).

    ``caches``: per layer a dict, ``{"attn": DenseKVCache |
    PagedPrefillCache | PagedDecodeCache}``, ``{"mamba": {h, conv}}`` or
    ``{"rwkv_tm": {s, x_prev}, "rwkv_cm": {x_prev}}`` (see
    :func:`init_caches`), or None (no state: full causal attention).
    ``cache_pos``: the position of a one-token decode step over
    DenseKVCaches; positions then default to ``cache_pos + arange(S)``. ``last_logits_only``: the head at
    the final position only. ``return_hidden``: the final hidden states
    instead of logits. ``impl`` selects kernels or plain versions (see
    :mod:`repro_torch.kernels.ops`). ``aux``: the MoE layers' load-balance
    losses summed (f32 scalar; zero without MoE layers).

    With ``cfg.remat``, no caches and grad enabled, each block runs under
    a checkpoint: its activations are recomputed in the backward pass, as
    the reference's ``jax.checkpoint`` per block.

    Under a sharded train step (:mod:`repro_torch.parallel.fsdp`)
    ``params`` holds this rank's blocks: each block gathers its layer
    where it runs and each top-level leaf is gathered around its use.
    Where the step splits the sequence (the multi-pod train rules'
    ``seq_act`` on ``pod``), ``inputs`` is this rank's block of
    positions: the embedding, the stash between blocks and the head hold
    that block alone (its positions global), and each mixer gathers its
    sequence (:mod:`~repro_torch.models.attention`,
    :mod:`~repro_torch.models.ssm`, :mod:`~repro_torch.models.rwkv`).
    """
    qmode = cfg.qmode if qmode is None else qmode
    b, s = inputs.shape[:2]
    if positions is None:
        base = torch.arange(s, device=inputs.device)
        if cache_pos is not None:
            base = base + cache_pos
        split = seq_split()
        if split is not None:          # this rank's block of the sequence
            base = base + split.seq_index * s
        positions = base.expand(b, s)
    if inputs.is_floating_point():
        if not cfg.embedding_inputs:
            raise ValueError(f"{cfg.name}: float inputs need a model with "
                             "embedding_inputs")
        h = inputs.to(dtype_of(cfg))
    else:
        # token ids past the vocabulary take its last row, as the
        # reference's gather clamps them (a narrow-vocabulary draft model
        # reads the target's tokens)
        h = embed(whole(params["embedding"], ("embedding",)),
                  inputs.clamp(max=cfg.vocab_size - 1)).to(dtype_of(cfg))
    new_caches = [] if caches is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, lp in enumerate(params["layers"]):
        cache_i = caches[i] if caches is not None else None
        if remat:
            h, c_new, aux = checkpoint(
                _block, lp, cfg, i, h, positions, None, cache_pos, qmode,
                impl, use_reentrant=False, preserve_rng_state=False)
        else:
            h, c_new, aux = _block(lp, cfg, i, h, positions, cache_i,
                                   cache_pos, qmode, impl)
        if new_caches is not None:
            new_caches.append(c_new)
        if aux is not None:
            aux_total = aux_total + aux
    h = rms_norm(h, whole(params["final_norm"], ("final_norm",)),
                 cfg.norm_eps)
    if return_hidden:
        return h, new_caches, aux_total
    if last_logits_only:
        h = h[:, -1:]
    head = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    logits = linear(h, head, qmode="none" if cfg.tie_embeddings else qmode,
                    impl=impl)
    if sharded("embedding" if cfg.tie_embeddings else "lm_head"):
        logits = all_gather_last(logits, tp_mesh()[0])   # vocab-sharded
    return logits, new_caches, aux_total


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``; under a serving mesh whose layout shards the
    embedding (``table`` this rank's block of vocabulary rows), the rows
    of the ids in the block, zeros elsewhere, summed over the ranks in f32
    (exact)."""
    if not sharded("embedding"):
        return table[ids]
    mesh, _ = tp_mesh()
    rows = table.shape[0]
    local = ids - mesh.coords["model"] * rows
    mine = (local >= 0) & (local < rows)
    part = table[local.clamp(0, rows - 1)].float()
    part = torch.where(mine[..., None], part, torch.zeros_like(part))
    return psum(part, mesh).to(table.dtype)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch = {'inputs': (B, S) int or (B, S, D) float, 'labels': (B, S)
    int} → the mean next-token cross entropy (f32 scalar), plus
    ``MOE_AUX_COEF`` × the aux loss for MoE configs. The head is streamed
    (:func:`chunked_xent`): the (B, S, V) logits are never held whole."""
    h, _, aux = forward(params, cfg, batch["inputs"], return_hidden=True)
    head = (whole(params["embedding"], ("embedding",)).T
            if cfg.tie_embeddings else whole(params["lm_head"], ("lm_head",)))
    loss = chunked_xent(h, head, batch["labels"])
    if cfg.moe_experts:
        loss = loss + MOE_AUX_COEF * aux
    return loss


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                kv_dtype: Optional[str] = None, device=None) -> list:
    """Per-layer decode caches: ``{"attn": DenseKVCache}`` (``kv_dtype=
    'int8'`` quantizes the slabs with per-page scales), the Mamba state
    ``{"mamba": {h, conv}}``, or the RWKV states ``{"rwkv_tm": {s,
    x_prev}}``, with ``"rwkv_cm": {x_prev}`` beside a channel mix."""
    device = resolve_device(device)
    dt = dtype_of(cfg)
    caches = []
    for i in range(cfg.n_layers):
        mixer = cfg.mixer_of(i)
        c: dict = {}
        if mixer == "attn":
            c["attn"] = attn_mod.init_cache(cfg, batch, max_len, dt,
                                            kv_dtype=kv_dtype, device=device)
        elif mixer == "mamba":
            c["mamba"] = ssm_mod.init_mamba_cache(cfg, batch, dt, device)
        else:
            hd = cfg.rwkv_head_dim
            c["rwkv_tm"] = {
                "s": torch.zeros(batch, cfg.d_model // hd, hd, hd,
                                 dtype=torch.float32, device=device),
                "x_prev": torch.zeros(batch, cfg.d_model, dtype=dt,
                                      device=device)}
        if cfg.ffn_of(i) == "rwkv_cmix":
            c["rwkv_cm"] = {"x_prev": torch.zeros(batch, cfg.d_model,
                                                  dtype=dt, device=device)}
        caches.append(c)
    return caches


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

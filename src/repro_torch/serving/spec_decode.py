"""One sequence's multi-token chunk through the paged-prefill call path.

Port of ``paged_chunk_forward`` from ``repro/serving/spec_decode.py``: the
one implementation behind the engine's prefill lane (and, in a later
slice, speculative verify panels). The drafters and the acceptance rule
come with speculative decoding.
"""
from __future__ import annotations

import torch


def paged_chunk_forward(params, cfg, pool, seq_id: int, tokens, start: int, *,
                        pages_per_step: int = 1, logits: str = "all",
                        impl: str = "auto"):
    """Run ``forward()`` over one sequence's chunk via PagedPrefillCache
    views: write the chunk's KV into the pool's pages, attend over the whole
    cached prefix, advance ``pool.lens``. ``logits``: 'all' (1, C, V) |
    'last' (1, 1, V) | 'none' (skip the vocabulary head). ``start`` need not
    be page-aligned."""
    from repro_torch.models.transformer import forward  # lazy: import cycle
    toks = torch.as_tensor(tokens, dtype=torch.long,
                           device=pool.device).reshape(1, -1)
    c = toks.shape[1]
    positions = (start + torch.arange(c, device=pool.device))[None]
    caches = [{"attn": pool.prefill_cache(i, seq_id, start, pages_per_step)}
              for i in range(cfg.n_layers)]
    kw = {"last_logits_only": True} if logits == "last" else \
        {"return_hidden": True} if logits == "none" else {}
    out, new_caches = forward(params, cfg, toks, positions=positions,
                              caches=caches, impl=impl, **kw)
    for i, layer in enumerate(new_caches):
        pool.writeback(i, layer["attn"])
    pool.lens[seq_id] = start + int(c)
    return None if logits == "none" else out

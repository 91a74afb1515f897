"""Serving: the KV caches (dense slab, paged pool), the continuous-batching
engine, speculative decoding and the dense-slab loop.

Engine symbols are re-exported lazily (PEP 562), as in the reference:
``repro_torch.models.attention`` imports :mod:`repro_torch.serving.kv_cache`
at module scope, and an eager ``engine`` import here would close the cycle
back through ``repro_torch.models.transformer`` before it finishes
initializing.
"""
from repro_torch.serving.kv_cache import (  # noqa: F401
    DenseKVCache,
    PagedDecodeCache,
    PagedPrefillCache,
    PagePool,
)
from repro_torch.serving.spec_decode import (  # noqa: F401
    DraftModelDrafter,
    NGramDrafter,
    SpecConfig,
    SpecStats,
    accept_speculative,
)

_ENGINE_EXPORTS = (
    "ContinuousBatchingEngine",
    "Request",
    "build_decode_step",
    "build_prefill_step",
    "generate",
    "init_serve_caches",
)


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from repro_torch.serving import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

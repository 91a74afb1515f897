"""The port's PagePool against the reference's, driven by the same traces.

Random reserve / register_prefix / fork / release / COW write / truncate
traces, as in tests/test_page_pool_properties.py, plus the data paths:
bulk ingest, page-aligned and unaligned chunk writes (PagedPrefillCache)
and decode appends (PagedDecodeCache). After every op the block tables,
lengths, refcounts, free list, retained LRU, shared_page_stats and
prefix matches must be identical and both pools must pass
check_invariants; page bytes and per-token scales must be bit-identical.

Tolerance: bit-exact. The reference runs these cache ops eagerly, which
divides by 127 and by the scale with correctly rounded f32 divisions; the
port computes the same chain.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from torch_parity import to_numpy  # noqa: E402

KV, HD, PS = 2, 8, 4
NUM_PAGES = 12
VOCAB = 5          # tiny alphabet → prompt prefixes collide often


def _pools(retain_pages=None):
    kw = dict(n_layers=2, n_kv_heads=KV, head_dim=HD, num_pages=NUM_PAGES,
              page_size=PS, retain_pages=retain_pages)
    return jkv.PagePool(**kw, quantized=True), \
        tkv.PagePool(**kw, device="cpu")


def _assert_same_state(jp, tp, probe_prompts=()):
    assert tp.tables == jp.tables
    assert tp.lens == jp.lens
    assert tp.ref == jp.ref
    assert tp.free == jp.free
    assert list(tp._retained) == list(jp._retained)
    assert tp.shared_page_stats() == jp.shared_page_stats()
    for prompt in probe_prompts:
        assert tp.match_prefix(prompt) == jp.match_prefix(prompt)
    jp.check_invariants()
    tp.check_invariants()


def _assert_same_pages(jp, tp):
    for layer in range(jp.n_layers):
        for jarr, tarr in ((jp.k_pages, tp.k_pages), (jp.v_pages, tp.v_pages),
                           (jp.k_scale, tp.k_scale), (jp.v_scale, tp.v_scale)):
            np.testing.assert_array_equal(tarr[layer].numpy(),
                                          np.asarray(jarr[layer]))


def _kv(rng, n):
    """A (1, KV, n, hd) f32 chunk, with an all-zero token now and then."""
    x = rng.standard_normal((1, KV, n, HD)).astype(np.float32) * 3
    if n > 1:
        x[:, :, 0] = 0.0
    return x


def _write(jp, tp, sid, n_tok, layer, nprng):
    """Chunk write at lens[sid] (aligned or not) through both views."""
    start = jp.lens[sid]
    k, v = _kv(nprng, n_tok), _kv(nprng, n_tok)
    for pidx in range(start // PS, (start + n_tok - 1) // PS + 1):
        assert jp.ensure_writable(sid, pidx) == tp.ensure_writable(sid, pidx)
    jc = jp.prefill_cache(layer, sid, start).write_chunk(jnp.asarray(k),
                                                         jnp.asarray(v))
    jp.writeback(layer, jc)
    tc = tp.prefill_cache(layer, sid, start).write_chunk(torch.from_numpy(k),
                                                         torch.from_numpy(v))
    tp.writeback(layer, tc)
    jp.lens[sid] = tp.lens[sid] = start + n_tok


def _append(jp, tp, sids, layer, nprng):
    """One decode append for every sequence in ``sids``."""
    for sid in sids:
        pidx = jp.lens[sid] // PS
        assert jp.ensure_writable(sid, pidx) == tp.ensure_writable(sid, pidx)
    k = nprng.standard_normal((len(sids), KV, HD)).astype(np.float32)
    v = nprng.standard_normal((len(sids), KV, HD)).astype(np.float32)
    jt, jl = jp.batch_tables(sids)
    tt, tl = tp.batch_tables(sids)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    jp.writeback(layer, jp.layer_cache(layer, jt, jl).append(
        jnp.asarray(k), jnp.asarray(v)))
    tp.writeback(layer, tp.layer_cache(layer, tt, tl).append(
        torch.from_numpy(k), torch.from_numpy(v)))
    for sid in sids:
        jp.lens[sid] += 1
        tp.lens[sid] += 1


def _apply_op(jp, tp, rng, nprng, next_id, prompts):
    resident = sorted(jp.tables)
    op = rng.choice(("reserve", "reserve", "fork", "release", "write",
                     "truncate", "ingest", "chunk", "chunk", "append"))
    if op == "reserve":
        n_tokens = rng.randint(1, 3 * PS)
        prompt = [rng.randrange(VOCAB) for _ in range(n_tokens)]
        prompts.append(prompt)
        if not jp.can_reserve(n_tokens, prompt=prompt):
            assert not tp.can_reserve(n_tokens, prompt=prompt)
            return
        sid = next_id[0]
        next_id[0] += 1
        assert tp.reserve(sid, n_tokens, prompt=prompt) == \
            jp.reserve(sid, n_tokens, prompt=prompt)
        if rng.random() < 0.7:
            assert tp.register_prefix(sid, prompt) == \
                jp.register_prefix(sid, prompt)
    elif op == "fork" and resident and jp.num_free > 0:
        parent = rng.choice(resident)
        sid = next_id[0]
        next_id[0] += 1
        jp.fork(parent, sid)
        tp.fork(parent, sid)
    elif op == "release" and resident:
        sid = rng.choice(resident)
        jp.release(sid)
        tp.release(sid)
    elif op == "write" and resident:
        sid = rng.choice(resident)
        idx = rng.randrange(len(jp.tables[sid]))
        if jp.ref[jp.tables[sid][idx]] > 1 and not jp.free:
            return                 # COW copy needs a free slot
        assert jp.ensure_writable(sid, idx) == tp.ensure_writable(sid, idx)
    elif op == "truncate" and resident:
        sid = rng.choice(resident)
        n = rng.randint(0, jp.lens[sid])
        trim = rng.random() < 0.5
        jp.truncate(sid, n, drop_unused_pages=trim)
        tp.truncate(sid, n, drop_unused_pages=trim)
    elif op == "ingest" and resident:
        sid = rng.choice(resident)
        start_page = jp.lens[sid] // PS
        n_pages = len(jp.tables[sid])
        if start_page >= n_pages:
            return
        n_tok = rng.randint(1, (n_pages - start_page) * PS)
        if any(jp.ref[s] > 1 for s in jp.tables[sid][
                start_page:start_page + jp.pages_for(n_tok)]):
            return                 # would write shared pages
        k, v = _kv(nprng, n_tok), _kv(nprng, n_tok)
        layer = rng.randrange(2)
        jp.ingest(sid, layer, jnp.asarray(k), jnp.asarray(v),
                  start=start_page * PS)
        tp.ingest(sid, layer, torch.from_numpy(k), torch.from_numpy(v),
                  start=start_page * PS)
    elif op in ("chunk", "append") and resident:
        sid = rng.choice(resident)
        room = len(jp.tables[sid]) * PS - jp.lens[sid]
        pages_needed = 1 + (jp.lens[sid] + min(room, PS + 1)) // PS
        if room <= 0 or len(jp.free) + len(jp._retained) < pages_needed:
            return                 # full, or COW copies could run dry
        if op == "chunk":
            _write(jp, tp, sid, rng.randint(1, min(room, PS + 2)),
                   rng.randrange(2), nprng)
        else:
            _append(jp, tp, [sid], rng.randrange(2), nprng)


@pytest.mark.parametrize("seed", range(12))
def test_pool_traces_match_reference(seed):
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    jp, tp = _pools(retain_pages=None if seed % 3 else 2)
    next_id, prompts = [0], []
    for _ in range(60):
        _apply_op(jp, tp, rng, nprng, next_id, prompts)
        _assert_same_state(jp, tp, prompts[-3:])
    _assert_same_pages(jp, tp)
    for sid in list(jp.tables):
        jp.release(sid)
        tp.release(sid)
    _assert_same_state(jp, tp, prompts)
    assert tp.num_free == tp.num_pages


def test_aligned_and_unaligned_writes_and_batched_append():
    """Chunk writes at an aligned start, then mid-page, then a batched
    decode append over three sequences, one of them forked (COW)."""
    nprng = np.random.default_rng(0)
    jp, tp = _pools()
    for sid in range(2):
        jp.reserve(sid, 3 * PS)
        tp.reserve(sid, 3 * PS)
    _write(jp, tp, 0, PS + 2, 0, nprng)        # aligned, partial tail page
    _write(jp, tp, 0, 3, 0, nprng)             # unaligned resume mid-page
    _write(jp, tp, 1, 5, 1, nprng)
    jp.fork(1, 2)
    tp.fork(1, 2)
    _append(jp, tp, [0, 1, 2], 1, nprng)       # seq 2's tail page is COW'd
    _append(jp, tp, [0, 2], 0, nprng)
    _assert_same_state(jp, tp)
    _assert_same_pages(jp, tp)


def test_int8_conversion_bit_exact():
    x = np.random.default_rng(1).standard_normal((3, KV, PS, HD)) \
        .astype(np.float32) * 4
    x[0, 0, 0] = 0.0
    jq, js = jkv._quantize_page_block(jnp.asarray(x))
    tq, ts = tkv._quantize_page_block(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0].item() == np.float32(tkv.SCALE_EPS)


def test_float_pages_not_ported():
    """Float pages, once refused here, are ported: the float pool (pages in
    the model dtype, no scales) holds exactly the reference's pages after
    the same ingest, aligned and unaligned chunk writes, and batched
    appends across a copy-on-write fork, in f32 and in bf16."""
    for dtype in ("float32", "bfloat16"):
        _check_float_pool(dtype)


def _check_float_pool(dtype):
    nprng = np.random.default_rng(3)
    kw = dict(n_layers=2, n_kv_heads=KV, head_dim=HD, num_pages=NUM_PAGES,
              page_size=PS, quantized=False)
    jp = jkv.PagePool(**kw, dtype=getattr(jnp, dtype))
    tp = tkv.PagePool(**kw, dtype=getattr(torch, dtype), device="cpu")
    assert tp.k_scale == [None, None] and tp.k_pages[0].dtype == \
        getattr(torch, dtype)
    for sid in range(2):
        jp.reserve(sid, 3 * PS)
        tp.reserve(sid, 3 * PS)
    k, v = _kv(nprng, PS + 1), _kv(nprng, PS + 1)
    jp.ingest(1, 1, jnp.asarray(k), jnp.asarray(v))
    tp.ingest(1, 1, torch.from_numpy(k), torch.from_numpy(v))
    _write(jp, tp, 0, PS + 2, 0, nprng)        # aligned, partial tail page
    _write(jp, tp, 0, 3, 0, nprng)             # unaligned resume mid-page
    jp.fork(1, 2)
    tp.fork(1, 2)
    _append(jp, tp, [0, 1, 2], 1, nprng)       # seq 2's tail page is COW'd
    _append(jp, tp, [0, 2], 0, nprng)
    _assert_same_state(jp, tp)
    for layer in range(2):
        assert tp.k_scale[layer] is None and tp.v_scale[layer] is None
        for jarr, tarr in ((jp.k_pages, tp.k_pages), (jp.v_pages, tp.v_pages)):
            np.testing.assert_array_equal(to_numpy(tarr[layer]),
                                          to_numpy(jarr[layer]))

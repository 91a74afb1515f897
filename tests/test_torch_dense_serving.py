"""The dense-slab serving path of the port against the reference's.

* ``DenseKVCache`` driven by the traces of tests/test_kv_cache.py:18-68 in
  both packages: int8 slabs and their per-page scales bit-identical after
  every op (the reference runs the cache ops eagerly; the port computes the
  same f32 chain, correctly rounded divisions included), float slabs equal.
* q-chunked causal attention (``attn_q_chunk``) against the reference's,
  and against the port's own unchunked forward.
* The port's versions of tests/test_serving.py:45-64, :65-76 and :88-130
  (int8 slab vs bf16 slab, prefill logits vs the full forward, paged int8
  decode vs the dense f32 slab for MQA / GQA / MHA), with those tests'
  tolerances, each also held against the reference where it compares
  logits.
* ``_generate_dense`` greedy streams equal to the reference's for
  kv_dtype None / int8 × qmode none / w8a8.
* ``generate`` sends a model with a recurrent mixer or embedding inputs to
  ``_generate_dense``, with its options, as the reference does, and the
  loop serves it.

Logit tolerance against the reference: 1% of max |logit|, as in
tests/test_torch_transformer.py (the reference's dense path runs eagerly).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import quantize_params as jax_quantize_params  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import forward, init_params  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from torch_parity import (check_streams, jax_to_numpy,  # noqa: E402
                          random_prompts, to_numpy)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

KV, HD, PS = 2, 16, 8
REL_TOL = 1e-2


def _pair(**overrides):
    """(jax cfg, jax params, port cfg, port params) for the reduced
    qwen2-0.5b with ``overrides``, the reference's weights carried over."""
    jcfg = jax_get_config("qwen2-0.5b", reduced=True, **overrides)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    return (jcfg, jp, get_config("qwen2-0.5b", reduced=True, **overrides),
            from_jax_params(jax_to_numpy(jp), device="cpu"))


@pytest.fixture(scope="module")
def model():
    return _pair()


def assert_logits_close(got, want, what, rel=REL_TOL):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, what
    err, tol = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= tol, f"{what}: max |Δlogit| {err} > {tol}"


# ---------------------------------------------------------------------------
# DenseKVCache against the reference's
# ---------------------------------------------------------------------------
def _caches(b, t, quantized, dtype):
    jc = jkv.DenseKVCache.init(b, KV, t, HD, getattr(jnp, dtype),
                               quantized=quantized, page_size=PS)
    tc = tkv.DenseKVCache.init(b, KV, t, HD, getattr(torch, dtype),
                               quantized=quantized, page_size=PS,
                               device="cpu")
    return jc, tc


def _assert_same_slab(jc, tc):
    assert tc.quantized == jc.quantized and tc.max_len == jc.max_len
    for jx, tx in ((jc.k, tc.k), (jc.v, tc.v), (jc.k_scale, tc.k_scale),
                   (jc.v_scale, tc.v_scale)):
        if jx is None:
            assert tx is None
            continue
        assert tuple(tx.shape) == jx.shape
        np.testing.assert_array_equal(to_numpy(tx), to_numpy(jx))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("quantized,dtype", [(True, "float32"),
                                             (False, "float32"),
                                             (False, "bfloat16")])
def test_dense_cache_prefill_and_append_trace(quantized, dtype):
    """tests/test_kv_cache.py:18: prefill 11 tokens of a 24-slot slab, then
    three appends across the page-1/page-2 boundary."""
    rng = np.random.default_rng(0)
    b, s, t = 2, 11, 24
    jc, tc = _caches(b, t, quantized, dtype)
    _assert_same_slab(jc, tc)
    jk, tk = _both(_rand(rng, b, KV, s, HD), dtype)
    jv, tv = _both(_rand(rng, b, KV, s, HD), dtype)
    jc, tc = jc.write_prefill(jk, jv), tc.write_prefill(tk, tv)
    _assert_same_slab(jc, tc)
    for i in range(3):
        jk, tk = _both(_rand(rng, b, KV, 1, HD) * 2, dtype)
        jv, tv = _both(_rand(rng, b, KV, 1, HD), dtype)
        jc = jc.append(jk, jv, jnp.int32(s + i))
        tc = tc.append(tk, tv, s + i)
        _assert_same_slab(jc, tc)
    for jx, tx in zip(jc.read(jnp.float32), tc.read(torch.float32)):
        assert tuple(tx.shape) == jx.shape
        np.testing.assert_array_equal(to_numpy(tx), to_numpy(jx))


@pytest.mark.parametrize("quantized,dtype", [(True, "float32"),
                                             (False, "bfloat16")])
def test_dense_cache_incremental_append_trace(quantized, dtype):
    """tests/test_kv_cache.py:44: one slab filled by appends, one token at a
    time (each int8 append requantizes its page), the other in bulk."""
    rng = np.random.default_rng(1)
    b, s = 1, PS + 3
    k, v = _rand(rng, b, KV, s, HD), _rand(rng, b, KV, s, HD)
    jinc, tinc = _caches(b, s, quantized, dtype)
    for i in range(s):
        jk, tk = _both(k[:, :, i:i + 1], dtype)
        jv, tv = _both(v[:, :, i:i + 1], dtype)
        jinc = jinc.append(jk, jv, jnp.int32(i))
        tinc = tinc.append(tk, tv, i)
        _assert_same_slab(jinc, tinc)
    jbulk, tbulk = _caches(b, s, quantized, dtype)
    jbulk = jbulk.write_prefill(*(_both(x, dtype)[0] for x in (k, v)))
    tbulk = tbulk.write_prefill(*(_both(x, dtype)[1] for x in (k, v)))
    _assert_same_slab(jbulk, tbulk)


def test_quantize_pages_bit_exact():
    x = _rand(np.random.default_rng(2), 2, KV, 3 * PS, HD) * 4
    x[0, 0, :PS] = 0.0                          # an all-zero page → SCALE_EPS
    jq, js = jkv._quantize_pages(jnp.asarray(x), PS)
    tq, ts = tkv._quantize_pages(torch.from_numpy(x), PS)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    paged = (2, KV, 3, PS, HD)
    np.testing.assert_array_equal(
        tkv.dequantize_int8(tq.reshape(paged), ts[..., None, None],
                            torch.bfloat16).float().numpy(),
        to_numpy(jkv.dequantize_int8(jq.reshape(paged), js[..., None, None],
                                     jnp.bfloat16)))


# ---------------------------------------------------------------------------
# q-chunked attention
# ---------------------------------------------------------------------------
def test_q_chunked_forward_matches_reference_and_unchunked():
    jcfg, jp, cfg, tp = _pair(attn_q_chunk=8)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32))
    want, _, _ = jax_forward(jp, jcfg, jnp.asarray(toks))
    got, _, _ = forward(tp, cfg, torch.from_numpy(toks))
    assert_logits_close(got, want, "q-chunked vs reference")
    plain_cfg = get_config("qwen2-0.5b", reduced=True)
    unchunked, _, _ = forward(tp, plain_cfg, torch.from_numpy(toks))
    assert_logits_close(got, unchunked, "q-chunked vs unchunked")
    with pytest.raises(ValueError):
        forward(tp, cfg, torch.from_numpy(toks[:, :12]))   # 12 % 8 != 0


def test_q_chunked_forward_f32_equals_unchunked():
    """In f32 each chunk's rows are computed as in the unchunked forward:
    only the row batching of the score product differs."""
    _, _, cfg, tp = _pair(attn_q_chunk=8, dtype="float32")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 24))
    got, _, _ = forward(tp, cfg, torch.from_numpy(toks))
    want, _, _ = forward(tp, get_config("qwen2-0.5b", reduced=True,
                                     dtype="float32"), torch.from_numpy(toks))
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=1e-5,
                               atol=1e-5 * np.abs(to_numpy(want)).max())


# ---------------------------------------------------------------------------
# Ports of tests/test_serving.py's dense-slab cases
# ---------------------------------------------------------------------------
def test_int8_kv_cache_close_to_bf16(model):
    """tests/test_serving.py:45: prefill logits do not read the cache, so
    int8 and bf16 slabs give the same logits; one decode step agrees on at
    least half the tokens. Both prefills also match the reference's."""
    jcfg, jp, cfg, tp = model
    b, s = 2, 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (b, s))
    pre = teng.build_prefill_step(cfg)
    caches_bf = teng.init_serve_caches(cfg, b, 32, device="cpu")
    caches_i8 = teng.init_serve_caches(cfg, b, 32, kv_dtype="int8",
                                       device="cpu")
    logits_bf, caches_bf = pre(tp, torch.from_numpy(toks), caches_bf)
    logits_i8, caches_i8 = pre(tp, torch.from_numpy(toks), caches_i8)
    np.testing.assert_allclose(to_numpy(logits_bf), to_numpy(logits_i8),
                               rtol=1e-2, atol=1e-2)
    want, _ = jeng.build_prefill_step(jcfg)(
        jp, jnp.asarray(toks), jeng.init_serve_caches(jcfg, b, 32))
    assert_logits_close(logits_bf, want, "bf16-slab prefill vs reference")
    dec = teng.build_decode_step(cfg)
    tok = logits_bf.float().argmax(-1)[:, None]
    t_bf, _ = dec(tp, caches_bf, tok, s)
    t_i8, _ = dec(tp, caches_i8, tok, s)
    assert (t_bf == t_i8).float().mean().item() >= 0.5


def test_prefill_last_logits_match_full_forward(model):
    """tests/test_serving.py:65."""
    _, _, cfg, tp = model
    toks = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12)))
    full, _, _ = forward(tp, cfg, toks)
    last, _ = teng.build_prefill_step(cfg)(
        tp, toks, teng.init_serve_caches(cfg, 2, 16, device="cpu"))
    np.testing.assert_allclose(to_numpy(last), to_numpy(full[:, -1]),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n_kv", [1, 2, 4])   # MQA / GQA / MHA
def test_paged_int8_decode_parity_vs_f32_dense(n_kv):
    """tests/test_serving.py:88: paged int8-KV decode logits track the dense
    f32 slab within 2e-2, driven with the same tokens; the dense decode
    logits also match the reference's dense decode."""
    jcfg, jp, cfg, tp = _pair(dtype="float32", n_heads=4, n_kv_heads=n_kv,
                              head_dim=16)
    b, s, steps, ps = 2, 12, 4, 8
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (b, s))
    caches = teng.init_serve_caches(cfg, b, s + steps, device="cpu")
    last, caches = teng.build_prefill_step(cfg)(tp, torch.from_numpy(toks),
                                                caches)
    jcaches = jeng.init_serve_caches(jcfg, b, s + steps)
    _, jcaches = jeng.build_prefill_step(jcfg)(jp, jnp.asarray(toks), jcaches)

    pool = tkv.PagePool(n_layers=cfg.n_layers, n_kv_heads=n_kv,
                        head_dim=cfg.hd,
                        num_pages=4 * b * ((s + steps) // ps + 1),
                        page_size=ps, quantized=True, device="cpu")
    for row in range(b):
        pool.reserve(row, s + steps)
        for i, layer in enumerate(caches):
            pool.ingest(row, i, layer["attn"].k[row:row + 1, :, :s],
                        layer["attn"].v[row:row + 1, :, :s])

    tok = last.float().argmax(-1)[:, None]
    for step in range(steps):
        logits_d, caches, _ = forward(tp, cfg, tok, caches=caches,
                                      cache_pos=s + step)
        want, jcaches, _ = jax_forward(jp, jcfg, jnp.asarray(tok.numpy()),
                                       caches=jcaches,
                                       cache_pos=jnp.int32(s + step))
        assert_logits_close(logits_d, want, f"n_kv={n_kv} dense step {step}")
        tables, lengths = pool.batch_tables(list(range(b)))
        pcaches = [{"attn": pool.layer_cache(i, tables, lengths)}
                   for i in range(cfg.n_layers)]
        logits_p, new_p, _ = forward(tp, cfg, tok,
                                     positions=lengths[:, None].long(),
                                     caches=pcaches)
        for i, layer in enumerate(new_p):
            pool.writeback(i, layer["attn"])
        for row in range(b):
            pool.lens[row] += 1
        np.testing.assert_allclose(to_numpy(logits_p), to_numpy(logits_d),
                                   rtol=2e-2, atol=2e-2,
                                   err_msg=f"n_kv={n_kv} decode step {step}")
        tok = logits_d[:, -1].float().argmax(-1)[:, None]


# ---------------------------------------------------------------------------
# _generate_dense against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("qmode", ["none", "w8a8"])
def test_generate_dense_greedy_streams_match_reference(model, kv_dtype, qmode):
    jcfg, jp, cfg, _ = model
    jq = jax_quantize_params(jp, jcfg, qmode)
    tq = from_jax_params(jax_to_numpy(jq), device="cpu")
    prompts = random_prompts([14, 14, 14], seed=40)
    batch = np.stack(prompts)
    want = jeng._generate_dense(jq, jcfg, jnp.asarray(batch), steps=6,
                                key=None, sample="greedy", temperature=1.0,
                                max_len=None, kv_dtype=kv_dtype)
    got = teng._generate_dense(tq, cfg, torch.from_numpy(batch), steps=6,
                               kv_dtype=kv_dtype, device="cpu")
    assert got.shape == (3, 6)
    check_streams(got.tolist(), np.asarray(want).tolist(), jcfg, jq, prompts)


def test_generate_dense_temperature_is_seeded(model):
    _, _, cfg, tp = model
    batch = torch.from_numpy(np.stack(random_prompts([10, 10], seed=41)))
    kw = dict(steps=5, sample="temperature", temperature=0.8, device="cpu")
    a = teng._generate_dense(tp, cfg, batch, seed=1, **kw)
    assert torch.equal(a, teng._generate_dense(tp, cfg, batch, seed=1, **kw))
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    with pytest.raises(ValueError):
        teng.build_decode_step(cfg, sample="top_p")


@pytest.mark.parametrize("change", [dict(embedding_inputs=True),
                                    dict(mixer_pattern=("attn", "mamba")),
                                    dict(mixer_pattern=("rwkv",))])
def test_generate_dispatches_to_dense_loop(model, monkeypatch, change):
    _, _, cfg, tp = model
    other = dataclasses.replace(cfg, **change)
    batch = torch.from_numpy(np.stack(random_prompts([6, 6], seed=42)))
    seen = {}

    def dense(params, cfg, prompt, **kw):
        seen.update(kw, cfg=cfg)
        return torch.zeros(prompt.shape[0], kw["steps"], dtype=torch.long)
    with monkeypatch.context() as m:
        m.setattr(teng, "_generate_dense", dense)
        out = teng.generate(tp, other, batch, steps=3, max_len=16,
                            kv_dtype="int8", device="cpu")
        assert out.shape == (2, 3) and seen["cfg"] is other
        assert (seen["max_len"], seen["kv_dtype"]) == (16, "int8")
        # an all-attention model stays on the engine
        teng.generate(tp, cfg, batch, steps=2, device="cpu")
        assert seen["cfg"] is other
    # the loop serves each such model: (B, steps) tokens of its vocabulary,
    # from a float (B, S, D) prompt for embedding inputs
    prompt = batch
    if other.embedding_inputs:
        prompt = torch.randn(2, 6, other.d_model, generator=torch.Generator(
            ).manual_seed(0)).to(torch.bfloat16)
    out = teng.generate(init_params(other, device="cpu"), other, prompt,
                        steps=3, device="cpu")
    assert out.shape == (2, 3) and out.dtype == torch.long
    assert ((out >= 0) & (out < other.vocab_size)).all()

"""The port's RWKV6 mixers (repro_torch/models/rwkv.py) and
``group_norm_heads`` against the reference's (repro/models/rwkv.py,
modules.py), on the reduced rwkv6-7b (d 64, 4 heads of 16, LoRA rank 8,
rwkv_chunk 8), with the reference's own weights carried across and the
same numpy inputs.

* Units against the jitted reference: ``group_norm_heads``,
  ``_wkv6_chunked`` (S 16: two chunks of 8; S 13: prime, chunks of 1),
  ``_wkv6_step``, ``rwkv_time_mix`` and ``rwkv_channel_mix`` (f32 and
  bf16, with and without a cache, S 16, 13 and 1). The chunked WKV is also
  held against the port's sequential oracle ``wkv6_sequential_ref``.
* The whole model: tests/test_torch_recurrent_serving.py.
* The WKV refuses TF32 on the card.

Tolerances. f32: within 1e-5 · max |y| of the jitted reference (the
einsums' f32 reduction orders differ; seen: up to ~1e-6 relative). The
chunked WKV against the sequential oracle: 1e-5 · max |y| too (the
chunked form factorises the decays; the reference's own property test
holds the two within rtol = atol = 1e-4, tests/test_properties.py:105).
bf16: 1% of max |y|, the port's forward tolerance
(tests/test_torch_transformer.py).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.modules as jmodules  # noqa: E402
import repro.models.rwkv as jrwkv  # noqa: E402
import repro_torch.models.modules as tmodules  # noqa: E402
import repro_torch.models.rwkv as trwkv  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from torch_parity import (assert_rel_close, cuda_like,  # noqa: E402
                          jax_to_numpy, to_numpy)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)

ARCH = "rwkv6-7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 1e-2}
# 16: two chunks of rwkv_chunk 8; 13: prime, chunk 1; 1: one decode step
LENGTHS = (16, 13, 1)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """(reference, port) time-mix and channel-mix weights in ``dtype``;
    the zero-initialised mixing vectors drawn at random so the token shift
    takes part."""
    jcfg = jax_get_config(ARCH, reduced=True)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(4), 3)
    jt = jrwkv.init_rwkv_time_mix(k1, jcfg, DTYPES[dtype][0])
    jc = jrwkv.init_rwkv_channel_mix(k2, jcfg, DTYPES[dtype][0])
    ks = jax.random.split(k3, 4)
    for tree, name, k in ((jt, "time_maa_x", ks[0]), (jt, "time_maa", ks[1]),
                          (jc, "maa_k", ks[2]), (jc, "maa_r", ks[3])):
        tree[name] = jax.random.uniform(k, tree[name].shape,
                                        tree[name].dtype)
    jp = {"tm": jt, "cm": jc}
    return jp, from_jax_params(jax_to_numpy(jp), device="cpu")


def _rand(shape, dtype, seed, scale=1.0):
    """(jax, torch) arrays of the same values in ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    x = jnp.asarray(a, DTYPES[dtype][0])
    return x, torch.from_numpy(to_numpy(x)).to(DTYPES[dtype][1])


def _wkv_inputs(s, seed, h=4, hd=16):
    """r, k, v, lw (B, S, H, hd), u (H, hd), s0 (B, H, hd, hd), f32, with
    lw in [-LW_MAX, -1e-4] as the mixer clamps it."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((2, s, h, hd)).astype(np.float32)
               for _ in range(3))
    lw = -rng.uniform(1e-4, jrwkv.LW_MAX, (2, s, h, hd)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
    s0 = rng.standard_normal((2, h, hd, hd)).astype(np.float32)
    return r, k, v, lw, u, s0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_norm_heads(dtype):
    """Population variance, as ``jnp.var``: torch's unbiased default would
    scale every output by sqrt(hd / (hd - 1))."""
    jx, tx = _rand((2, 5, 4, 16), dtype, 1, 3.0)
    js, ts = _rand((4, 16), dtype, 2)
    jb, tb = _rand((4, 16), dtype, 3)
    want = jax.jit(jmodules.group_norm_heads)(jx, js, jb, 1e-5)
    got = tmodules.group_norm_heads(tx, ts, tb, 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    assert_rel_close(got, want, REL[dtype])


@pytest.mark.parametrize("s", LENGTHS[:2])
def test_wkv6_chunked(s):
    """Chunk 8 at S 16 (two chunks), 1 at S 13; against the jitted
    reference and the port's sequential oracle."""
    chunk = 8 if s % 8 == 0 else 1
    args = _wkv_inputs(s, s)
    want = jax.jit(jrwkv._wkv6_chunked, static_argnums=6)(*args, chunk)
    targs = [torch.from_numpy(a) for a in args]
    got = trwkv._wkv6_chunked(*targs, chunk)
    seq = trwkv.wkv6_sequential_ref(*targs)
    for g, w, q, what in zip(got, want, seq, ("y", "s_final")):
        assert_rel_close(g, w, REL["float32"], what)
        assert_rel_close(g, q, REL["float32"], what + " vs sequential")


def test_wkv6_step():
    args = _wkv_inputs(1, 7)
    want = jax.jit(jrwkv._wkv6_step)(*args)
    got = trwkv._wkv6_step(*map(torch.from_numpy, args))
    for g, w, what in zip(got, want, ("y", "s1")):
        assert_rel_close(g, w, REL["float32"], what)


def _cache(cfg, dtype, seed):
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    js, ts = _rand((2, h, hd, hd), "float32", seed, 0.5)
    jx, tx = _rand((2, cfg.d_model), dtype, seed + 1)
    jc, tc = _rand((2, cfg.d_model), dtype, seed + 2)
    return ({"s": js, "x_prev": jx}, {"x_prev": jc}), \
        ({"s": ts, "x_prev": tx}, {"x_prev": tc})


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_time_mix(cfgs, dtype, with_cache, s):
    jcfg, cfg = cfgs
    jp, tp = _params(dtype)
    jx, tx = _rand((2, s, cfg.d_model), dtype, 10 + s)
    jc = tc = None
    if with_cache:
        (jc, _), (tc, _) = _cache(cfg, dtype, 20 + s)
    fn = jax.jit(lambda p, x, c: jrwkv.rwkv_time_mix(p, jcfg, x, cache=c))
    want_y, want_c = fn(jp["tm"], jx, jc)
    got_y, got_c = trwkv.rwkv_time_mix(tp["tm"], cfg, tx, cache=tc)
    assert got_y.dtype == DTYPES[dtype][1]
    assert_rel_close(got_y, want_y, REL[dtype], "y")
    if not with_cache:
        assert got_c is None and want_c is None
        return
    assert got_c["s"].dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(got_c["x_prev"]),
                                  to_numpy(tx[:, -1]))   # the mixer's input
    assert_rel_close(got_c["s"], want_c["s"], REL[dtype], "s")


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rwkv_channel_mix(cfgs, dtype, with_cache, s):
    jcfg, cfg = cfgs
    jp, tp = _params(dtype)
    jx, tx = _rand((2, s, cfg.d_model), dtype, 30 + s)
    jc = tc = None
    if with_cache:
        (_, jc), (_, tc) = _cache(cfg, dtype, 40 + s)
    fn = jax.jit(lambda p, x, c: jrwkv.rwkv_channel_mix(p, jcfg, x, cache=c))
    want_y, want_c = fn(jp["cm"], jx, jc)
    got_y, got_c = trwkv.rwkv_channel_mix(tp["cm"], cfg, tx, cache=tc)
    assert got_y.dtype == DTYPES[dtype][1]
    assert_rel_close(got_y, want_y, REL[dtype], "y")
    if with_cache:
        np.testing.assert_array_equal(to_numpy(got_c["x_prev"]),
                                      to_numpy(want_c["x_prev"]))
    else:
        assert got_c is None and want_c is None


def test_init_rwkv_shapes(cfgs):
    """The port's own init: the reference's leaves, shapes and dtypes."""
    jcfg, cfg = cfgs
    gen = torch.Generator().manual_seed(0)
    for jfn, tfn in ((jrwkv.init_rwkv_time_mix, trwkv.init_rwkv_time_mix),
                     (jrwkv.init_rwkv_channel_mix,
                      trwkv.init_rwkv_channel_mix)):
        want = jfn(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
        got = tfn(gen, cfg, torch.bfloat16, "cpu")
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert got[k].dtype == torch.bfloat16, k


def test_rwkv_refuses_tf32(cfgs, monkeypatch):
    """On the card the WKV must stay f32; TF32 would change its einsums."""
    _, cfg = cfgs
    _, tp = _params("float32")
    _, tx = _rand((2, 4, cfg.d_model), "float32", 5)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    trwkv.rwkv_time_mix(tp["tm"], cfg, tx)           # CPU: unaffected
    with pytest.raises(RuntimeError, match="TF32"):
        trwkv.rwkv_time_mix(tp["tm"], cfg, cuda_like(tx))

"""The port's Mamba mixer (repro_torch/models/ssm.py) against the
reference's (repro/models/ssm.py), on the reduced jamba-v0.1-52b (d 64,
d_inner 128, state 8, dt rank 8, conv 4, ssm_seq_chunks 4), with the
reference's own weights carried across and the same numpy inputs.

* Units against the jitted reference: ``_causal_conv`` (with and without
  ``prev``), ``_ssm_scan_segment`` and ``mamba_mixer`` (f32 and bf16, with
  and without a cache, prompt lengths 16 (four scan segments), 13 (prime:
  one segment) and 1 (one decode step)).
* The whole model: tests/test_torch_recurrent_serving.py.
* The scan refuses TF32 on the card.

Tolerances of the units. f32: within 1e-5 · max |y| of the jitted
reference. The port runs ``jax.lax.associative_scan``'s own recursion (bit
for bit against the eager reference), but under jit XLA fuses products
and sums (seen: up to ~1.4e-7 relative). bf16: 1% of max |y|, the port's
forward tolerance (tests/test_torch_transformer.py): one bf16 ULP of the
largest value is up to 2^-7 ≈ 0.78% of it, and f32 reduction orders can
flip a rounding.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models.ssm as jssm  # noqa: E402
import repro_torch.models.ssm as tssm  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from torch_parity import (assert_rel_close, assert_ulps,  # noqa: E402
                          cuda_like, jax_to_numpy, to_numpy)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)

ARCH = "jamba-v0.1-52b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 1e-2}
# 16: four scan segments (ssm_seq_chunks 4); 13: prime, one segment; 1: decode
LENGTHS = (16, 13, 1)


@pytest.fixture(scope="module")
def cfgs():
    return jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)


@functools.lru_cache(maxsize=None)
def _params(dtype):
    jcfg = jax_get_config(ARCH, reduced=True)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jcfg, DTYPES[dtype][0])
    return jp, from_jax_params(jax_to_numpy(jp), device="cpu")


def _rand(shape, dtype, seed, scale=1.0):
    """(jax, torch) arrays of the same values in ``dtype``."""
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    x = jnp.asarray(a, DTYPES[dtype][0])
    return x, torch.from_numpy(to_numpy(x)).to(DTYPES[dtype][1])


def _cache(cfg, dtype, seed):
    jh, th = _rand((2, cfg.d_inner, cfg.ssm_state_dim), "float32", seed, 0.5)
    jc, tc = _rand((2, cfg.ssm_conv_dim - 1, cfg.d_inner), dtype, seed + 1)
    return {"h": jh, "conv": jc}, {"h": th, "conv": tc}


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv(cfgs, dtype, with_prev):
    jcfg, cfg = cfgs
    jp, tp = _params(dtype)
    jx, tx = _rand((2, 13, cfg.d_inner), dtype, 1)
    jprev = tprev = None
    if with_prev:
        jprev, tprev = _rand((2, cfg.ssm_conv_dim - 1, cfg.d_inner), dtype, 2)
    want = jax.jit(jssm._causal_conv)(jx, jp["conv_w"], jp["conv_b"], jprev)
    got = tssm._causal_conv(tx, tp["conv_w"], tp["conv_b"], tprev)
    for g, w, what in zip(got, want, ("y", "new_prev")):
        assert g.dtype == DTYPES[dtype][1]
        assert_rel_close(g, w, REL[dtype], what)


@pytest.mark.parametrize("s", LENGTHS)
def test_ssm_scan_segment(s):
    """The scan's inputs are f32 in both packages (the mixer builds them
    in f32 from either activation dtype). Bit for bit against the eager
    reference, within the f32 tolerance of the jitted one."""
    shape = (2, s, 16, 8)
    rng = np.random.default_rng(s)
    a = np.exp(-rng.uniform(0.0, 0.5, shape)).astype(np.float32)
    bu = rng.standard_normal(shape).astype(np.float32)
    h0 = rng.standard_normal((2, 16, 8)).astype(np.float32)
    want = jax.jit(jssm._ssm_scan_segment)(a, bu, h0)
    got = tssm._ssm_scan_segment(*map(torch.from_numpy, (a, bu, h0)))
    eager = jssm._ssm_scan_segment(a, bu, h0)
    for g, w, e, what in zip(got, want, eager, ("h_all", "h_last")):
        assert_rel_close(g, w, REL["float32"], what)
        np.testing.assert_array_equal(to_numpy(g), to_numpy(e))


@pytest.mark.parametrize("s", LENGTHS)
@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_mixer(cfgs, dtype, with_cache, s):
    jcfg, cfg = cfgs
    jp, tp = _params(dtype)
    jx, tx = _rand((2, s, cfg.d_model), dtype, 10 + s)
    jc = tc = None
    if with_cache:
        jc, tc = _cache(cfg, dtype, 20 + s)
    fn = jax.jit(lambda p, x, c: jssm.mamba_mixer(p, jcfg, x, cache=c))
    want_y, want_c = fn(jp, jx, jc)
    got_y, got_c = tssm.mamba_mixer(tp, cfg, tx, cache=tc)
    assert got_y.dtype == DTYPES[dtype][1]
    assert_rel_close(got_y, want_y, REL[dtype], "y")
    if not with_cache:
        assert got_c is None and want_c is None
        return
    assert got_c["h"].dtype == torch.float32
    assert got_c["conv"].dtype == DTYPES[dtype][1]
    for key in ("h", "conv"):
        assert_rel_close(got_c[key], want_c[key], REL[dtype], key)


def test_init_mamba_shapes(cfgs):
    """The port's own init: the reference's leaves, shapes and dtypes."""
    jcfg, cfg = cfgs
    want = jssm.init_mamba(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    got = tssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                          torch.bfloat16, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    for k in ("conv_b", "dt_bias", "D"):                # deterministic
        np.testing.assert_array_equal(to_numpy(got[k]), to_numpy(want[k]))
    # log(1..N): torch's and XLA's log differ in the last bit here and there
    assert_ulps(to_numpy(got["A_log"]), to_numpy(want["A_log"]), 1, "float32")
    cache = tssm.init_mamba_cache(cfg, 3, torch.bfloat16, "cpu")
    want_c = jssm.init_mamba_cache(jcfg, 3, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in want_c.items()}


def test_mamba_refuses_tf32(cfgs, monkeypatch):
    """On the card the scan must stay f32; TF32 would change its
    contraction with C."""
    _, cfg = cfgs
    _, tp = _params("float32")
    _, tx = _rand((2, 4, cfg.d_model), "float32", 5)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    tssm.mamba_mixer(tp, cfg, tx)                    # CPU: unaffected
    with pytest.raises(RuntimeError, match="TF32"):
        tssm.mamba_mixer(tp, cfg, cuda_like(tx))

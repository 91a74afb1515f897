"""K1 (fused w8a8 GEMM) plain version and dispatch against the reference.

The same numpy inputs go into the jitted reference (``ops.gemm_i8_fused``
with impl='xla', which the reference engine runs, and the interpret-mode
Pallas kernel) and into the port on the CPU (the plain version).

Tolerances:
* quantized payloads (int8 activations and their scales): bit-exact. The
  reference's GEMM is jitted, and under jit XLA computes ``absmax / 127``
  as ``absmax * f32(1/127)``; the port computes the same chain.
* outputs for epilogues none/bias/mul/residual, f32 and bf16: bit-exact
  (exact int32 dot, the same f32 flush, the same rounding to bf16).
* silu/gelu: the transcendental may differ by a few ULPs between XLA and
  PyTorch: ≤ 4 ULP in f32, ≤ 1 bf16 ULP after the cast. ULPs are counted
  at the larger of the output's and the pre-activation's magnitude: gelu's
  tanh form cancels in its negative tail (1 + tanh(z) → 0), where two
  libraries' tanh differ by many ULPs of the tiny output while the error
  stays within a few ULPs of the input.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import camp as jcamp  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.camp_gemm_fused import camp_gemm_fused_w8a8  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import quantize_params as jax_quantize_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import camp, quant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import quantize_params  # noqa: E402
from torch_parity import (assert_ulps, jax_to_numpy,  # noqa: E402
                          pre_activation_epilogue, to_numpy)

SHAPES = [(1, 96, 40), (3, 100, 72), (17, 200, 64)]    # ragged M, K % 32 != 0
EPILOGUES = ["none", "bias", "silu", "gelu", "residual", "mul", "bias+silu",
             "bias+gelu+residual"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pre_activation(jx, wq, jb, epilogue):
    """The reference's f32 output just before the silu/gelu stage."""
    pre = pre_activation_epilogue(epilogue)
    return to_numpy(jops.gemm_i8_fused(jx, wq.q, wq.scale, impl="xla",
                                       epilogue=pre,
                                       bias=jb if "bias" in pre else None))


def _inputs(m, k, n, epilogue, dt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :7] = 0.0                      # some exact zeros
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32) if "bias" in epilogue \
        else None
    opd = rng.standard_normal((m, n)).astype(np.float32) \
        if ("mul" in epilogue or "residual" in epilogue) else None
    jdt, tdt = DTYPES[dt]
    wq = jquant.quantize_weight(jnp.asarray(w), 8)
    jx = jnp.asarray(x, jdt)

    def pair(a):
        if a is None:
            return None, None
        ja = jnp.asarray(a, jdt)
        return ja, torch.from_numpy(to_numpy(ja)).to(tdt)

    jb, tb = pair(bias)
    jo, to = pair(opd)
    tx = torch.from_numpy(to_numpy(jx)).to(tdt)
    tq = torch.from_numpy(np.asarray(wq.q))
    ts = torch.from_numpy(np.asarray(wq.scale))
    return (jx, wq, jb, jo), (tx, tq, ts, tb, to)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_activation_quantization_bit_exact(dt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((37, 300)).astype(np.float32) * 3
    x[5] = 0.0                           # zero row → scale 1
    jx = jnp.asarray(x, DTYPES[dt][0])
    jq, js = jax.jit(jref.quantize_rowwise_ref)(jx)
    tq, ts = ref.quantize_rowwise_ref(
        torch.from_numpy(to_numpy(jx)).to(DTYPES[dt][1]))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_weight_quantization_bit_exact():
    """quantize_colwise/rowwise against the reference as it runs them
    (eagerly: a correctly rounded division by 127)."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 3] = 0.0
    jq, js = jquant.quantize_colwise(jnp.asarray(w))
    tq, ts = quant.quantize_colwise(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = jquant.quantize_rowwise(jnp.asarray(w))
    tq, ts = quant.quantize_rowwise(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gemm_i8_fused_matches_reference(shape, epilogue, dt):
    m, k, n = shape
    (jx, wq, jb, jo), (tx, tq, ts, tb, to) = _inputs(m, k, n, epilogue, dt,
                                                     seed=m * 1000 + k)
    jdt, tdt = DTYPES[dt]
    want = to_numpy(jops.gemm_i8_fused(jx, wq.q, wq.scale, out_dtype=jdt,
                                       impl="xla", epilogue=epilogue,
                                       bias=jb, operand=jo))
    got = to_numpy(ops.gemm_i8_fused(tx, tq, ts, out_dtype=tdt,
                                     epilogue=epilogue, bias=tb, operand=to))
    if "silu" in epilogue or "gelu" in epilogue:
        assert_ulps(got, want, 4 if dt == "float32" else 1, dt,
                    scale=_pre_activation(jx, wq, jb, epilogue))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_gemm_matches_interpret_pallas_kernel(shape, dt):
    """Secondary evidence: the Pallas kernel itself (interpret mode)."""
    m, k, n = shape
    epilogue = "bias+silu"
    (jx, wq, jb, jo), (tx, tq, ts, tb, to) = _inputs(m, k, n, epilogue, dt,
                                                     seed=7 + m)
    jdt, tdt = DTYPES[dt]
    want = to_numpy(camp_gemm_fused_w8a8(
        jx, wq.q, wq.scale, block_m=16, block_n=32, block_k=64,
        out_dtype=jdt, epilogue=epilogue, bias=jb, interpret=True))
    got = to_numpy(ops.gemm_i8_fused(tx, tq, ts, out_dtype=tdt,
                                     epilogue=epilogue, bias=tb, impl="torch"))
    assert_ulps(got, want, 4 if dt == "float32" else 1, dt)


@pytest.mark.parametrize("qmode", ["w8a8", "w8a16", "none"])
def test_camp_matmul_matches_reference(qmode):
    """3-D activations, bias + silu epilogue, bf16 output."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 48)) * 0.1, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(48), jnp.bfloat16)
    jw = jcamp.prepare_weight(w, qmode)
    tw = from_jax_params(jax_to_numpy({"w": jw}), device="cpu")["w"]
    want = to_numpy(jcamp.camp_matmul(x, jw, qmode=qmode, epilogue="bias+silu",
                                      bias=b))
    tx = torch.from_numpy(to_numpy(x)).to(torch.bfloat16)
    tb = torch.from_numpy(to_numpy(b)).to(torch.bfloat16)
    got = to_numpy(camp.camp_matmul(tx, tw, qmode=qmode, epilogue="bias+silu",
                                    bias=tb))
    assert got.shape == (2, 5, 48)
    assert_ulps(got, want, 1, "bfloat16")


def test_int4_qmodes_refuse_odd_k():
    """The int4 qmodes (their parity is in test_torch_int4.py) prepare and
    multiply a weight of even K, and refuse what the reference refuses: a
    weight with an odd K cannot be packed two per byte."""
    x = torch.zeros(2, 64)
    for qmode in ("w4a8", "w4a4", "w4a16"):
        w = camp.prepare_weight(torch.zeros(64, 8), qmode)
        assert (w.bits, tuple(w.q.shape), w.shape) == (4, (32, 8), (64, 8))
        assert camp.camp_matmul(x, w, qmode=qmode).shape == (2, 8)
        with pytest.raises(ValueError, match="even"):
            camp.prepare_weight(torch.zeros(63, 8), qmode)


def test_quantize_params_matches_reference_per_leaf():
    """Every leaf of the port's PTQ equals the reference's, bit for bit."""
    jcfg = jax_get_config("qwen2-0.5b", reduced=True)
    cfg = get_config("qwen2-0.5b", reduced=True)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    want = jax_to_numpy(jax_quantize_params(jp, jcfg, "w8a8"))
    got_tree = quantize_params(from_jax_params(jax_to_numpy(jp), device="cpu"),
                               cfg, "w8a8")

    def walk(w, g, path):
        if isinstance(w, dict) and "q" in w:
            assert isinstance(g, quant.QuantizedTensor), path
            assert (g.bits, g.shape) == (w["bits"], w["shape"]), path
            np.testing.assert_array_equal(g.q.numpy(), w["q"], err_msg=path)
            np.testing.assert_array_equal(g.scale.numpy(), w["scale"],
                                          err_msg=path)
        elif isinstance(w, dict):
            assert set(w) == set(g), path
            for key in w:
                walk(w[key], g[key], f"{path}/{key}")
        elif isinstance(w, list):
            for i, (a, b) in enumerate(zip(w, g)):
                walk(a, b, f"{path}/{i}")
        else:
            assert not isinstance(g, quant.QuantizedTensor), path
            np.testing.assert_array_equal(to_numpy(g), to_numpy(
                w.view(jnp.bfloat16) if w.dtype == np.uint16 else w),
                err_msg=path)

    walk(want, got_tree, "")

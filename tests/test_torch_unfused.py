"""The unfused quantize → GEMM path of the port against the reference:
K7 (rowwise quantize, bits 8/4), K5 (int8 GEMM), K6a (int8 × packed int4)
and K6b (packed int4 × packed int4), the fused == unfused identity, and
``camp_matmul`` in all six qmodes.

The same numpy inputs go into the reference and into the port on the CPU.
The reference is compared as it is compiled: the interpret-mode Pallas
kernels, and ``ops.*(impl='xla')`` under ``jax.jit``. Jitted (and
interpret-mode) XLA computes ``absmax / qmax`` as ``absmax * f32(1/qmax)``
and contracts the GEMM's scale multiply with a first bias/residual add
into one FMA (both measured on the CPU, for qmax 127 and 7); the eager
reference does neither, and its unfused ``camp_matmul`` runs eagerly, so
eager results may differ from the jitted ones in the last bit.

Tolerances:
* K7's int8/int4 payloads and scales: bit-exact.
* K5/K6a/K6b and ``camp_matmul`` in the integer modes: bit-exact for
  none/bias/mul/residual; silu/gelu ≤ 4 f32 ULPs, ≤ 1 bf16 ULP after the
  cast, at the larger of the output's and the pre-activation's magnitude
  (test_torch_gemm.py says why).
* ``camp_matmul`` fused == unfused in the port: bit-exact, every epilogue.
* the float modes (none, w8a16, w4a16), against the eager reference:
  ≤ 1 bf16 ULP (a bf16 matmul's f32 sums are ordered differently by XLA
  and PyTorch).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import camp as jcamp  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.camp_gemm import camp_gemm_i8 as pallas_i8  # noqa: E402
from repro.kernels.camp_gemm_w4 import camp_gemm_a4w4 as pallas_a4w4  # noqa: E402
from repro.kernels.camp_gemm_w4 import camp_gemm_w4 as pallas_w4  # noqa: E402
from repro.kernels.quantize import quantize_rowwise_kernel as pallas_quant  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import camp, quant  # noqa: E402
from repro_torch.kernels import camp_gemm as k5  # noqa: E402
from repro_torch.kernels import camp_gemm_w4 as k6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as k7  # noqa: E402
from repro_torch.kernels import ref as ref_mod  # noqa: E402
from torch_parity import (assert_ulps, jax_to_numpy,  # noqa: E402
                          pre_activation_epilogue, to_numpy)

SHAPES = [(64, 128, 64), (50, 200, 72), (3, 96, 40)]
EPILOGUES = ["none", "bias", "silu", "gelu", "bias+silu", "residual", "mul",
             "bias+gelu+residual"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KINDS = ["i8", "w4", "a4w4"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mk", [(64, 128), (50, 200), (3, 96)])
def test_k7_quantize_matches_reference(mk, bits, dt):
    m, k = mk
    rng = np.random.default_rng(m + bits)
    x = (rng.standard_normal((m, k))
         * rng.uniform(0.01, 100.0, (m, 1))).astype(np.float32)
    x[1] = 0.0                                     # a zero row → (0, 1)
    jx = jnp.asarray(x, DTYPES[dt][0])
    tx = torch.from_numpy(to_numpy(jx)).to(DTYPES[dt][1])
    got_q, got_s = k7.quantize_rowwise_kernel(tx, bits=bits)
    assert got_q.dtype == torch.int8 and got_s.shape == (m, 1)
    assert (got_q[1] == 0).all() and got_s[1].item() == 1.0
    for want_q, want_s in (
            pallas_quant(jx, bits=bits, block_m=16, interpret=True),
            jax.jit(functools.partial(jops.quantize_rowwise, bits=bits,
                                      impl="xla"))(jx)):
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    q, s = ops.quantize_rowwise(tx, bits=bits)
    assert torch.equal(q, got_q) and torch.equal(s, got_s)


def _gemm_inputs(kind, m, k, n, epilogue, dt, seed):
    """Integer operands in the kind's layout, scales, bias and operand."""
    rng = np.random.default_rng(seed)
    a_max = 7 if kind == "a4w4" else 127
    a = rng.integers(-a_max, a_max + 1, (m, k)).astype(np.int8)
    b_max = 127 if kind == "i8" else 7
    b = rng.integers(-b_max, b_max + 1, (k, n)).astype(np.int8)
    sa = rng.uniform(0.001, 0.05, (m, 1)).astype(np.float32)
    sb = rng.uniform(0.001, 0.05, (1, n)).astype(np.float32)
    if kind != "i8":
        b = np.asarray(jquant.pack_int4(jnp.asarray(b)))
    if kind == "a4w4":
        a = np.asarray(jquant.pack_int4(jnp.asarray(a).T).T)
    jdt, tdt = DTYPES[dt]

    def pair(shape, needed):
        if not needed:
            return None, None
        ja = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
        return ja, torch.from_numpy(to_numpy(ja)).to(tdt)

    jb, tb = pair(n, "bias" in epilogue)
    jo, to = pair((m, n), "mul" in epilogue or "residual" in epilogue)
    return (a, b, sa, sb), (jb, jo), (tb, to)


def _port_gemm(kind, a, b, sa, sb, k, **kw):
    if kind == "i8":
        return k5.camp_gemm_i8(_t(a), _t(b), _t(sa), _t(sb), **kw)
    if kind == "w4":
        return k6.camp_gemm_w4(_t(a), _t(b), _t(sa), _t(sb), **kw)
    return k6.camp_gemm_a4w4(_t(a), _t(b), _t(sa), _t(sb), **kw)


def _jitted_ref_gemm(kind, a, b, sa, sb, k, *, out_dtype, epilogue, bias,
                     operand):
    fn = {"i8": jops.gemm_i8, "w4": jops.gemm_w4,
          "a4w4": functools.partial(jops.gemm_a4w4, k=k)}[kind]

    def run(a, b, sa, sb, bias, operand):
        kw = dict(impl="xla", out_dtype=out_dtype, epilogue=epilogue,
                  bias=bias, operand=operand)
        if kind == "a4w4":
            return fn(a, b, a_scale=sa, b_scale=sb, **kw)
        return fn(a, b, sa, sb, **kw)
    return jax.jit(run)(a, b, sa, sb, bias, operand)


def _check(got, want, dt, pre):
    if pre is None:
        np.testing.assert_array_equal(got, want)
    else:
        assert_ulps(got, want, 4 if dt == "float32" else 1, dt, scale=pre)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_k5_k6_plain_match_jitted_reference(kind, shape, epilogue, dt):
    m, k, n = shape
    (a, b, sa, sb), (jb, jo), (tb, to) = _gemm_inputs(
        kind, m, k, n, epilogue, dt, seed=3 * m + k)
    jdt, tdt = DTYPES[dt]

    def ref(epi):
        return to_numpy(_jitted_ref_gemm(
            kind, a, b, sa, sb, k, out_dtype=jdt, epilogue=epi,
            bias=jb if "bias" in epi else None,
            operand=jo if ("mul" in epi or "residual" in epi) else None))

    got = to_numpy(_port_gemm(kind, a, b, sa, sb, k, out_dtype=tdt,
                              epilogue=epilogue, bias=tb, operand=to))
    pre = pre_activation_epilogue(epilogue)
    _check(got, ref(epilogue), dt, None if pre is None else ref(pre))
    if epilogue == "none":        # the port's bare oracles (kernels/ref.py)
        oracle = {"i8": ref_mod.gemm_i8_ref, "w4": ref_mod.gemm_w4_ref,
                  "a4w4": functools.partial(ref_mod.gemm_a4w4_ref, k=k)}[kind]
        np.testing.assert_array_equal(got, to_numpy(oracle(
            _t(a), _t(b), a_scale=_t(sa), b_scale=_t(sb), out_dtype=tdt)))


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_k5_k6_plain_match_interpret_pallas_kernels(kind, shape, epilogue):
    m, k, n = shape
    (a, b, sa, sb), (jb, jo), (tb, to) = _gemm_inputs(
        kind, m, k, n, epilogue, "float32", seed=5 * m + k)
    fn = {"i8": pallas_i8, "w4": pallas_w4, "a4w4": pallas_a4w4}[kind]
    want = to_numpy(fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sa),
                       jnp.asarray(sb), block_m=32, block_n=32, block_k=64,
                       epilogue=epilogue, bias=jb, operand=jo,
                       interpret=True))
    got = to_numpy(_port_gemm(kind, a, b, sa, sb, k, epilogue=epilogue,
                              bias=tb, operand=to))
    pre = pre_activation_epilogue(epilogue)
    if pre is not None:
        pre = to_numpy(_port_gemm(kind, a, b, sa, sb, k, epilogue=pre,
                                  bias=tb if "bias" in pre else None))
    _check(got, want, "float32", pre)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("qmode", ["w8a8", "w4a8", "w4a4"])
def test_fused_equals_unfused(qmode, dt):
    """camp_matmul(fused=True) == camp_matmul(fused=False) bit for bit,
    every epilogue and shape: K7's chain is K1/K4's prologue, and the
    unfused GEMMs flush like the fused ones."""
    tdt = DTYPES[dt][1]
    rng = np.random.default_rng(9)
    for m, k, n in SHAPES:
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)
                             ).to(tdt)
        w = camp.prepare_weight(torch.from_numpy(
            rng.standard_normal((k, n)).astype(np.float32)), qmode)
        bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        opd = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
        for epi in EPILOGUES:
            kw = dict(qmode=qmode, epilogue=epi,
                      bias=bias if "bias" in epi else None,
                      operand=opd if ("mul" in epi or "residual" in epi)
                      else None)
            fused = camp.camp_matmul(x, w, fused=True, **kw)
            unfused = camp.camp_matmul(x, w, fused=False, **kw)
            assert torch.equal(fused, unfused), (m, k, n, epi)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("qmode", list(camp.QMODES))
def test_camp_matmul_matches_jitted_reference(qmode, fused):
    """3-D bf16 activations, bf16 output, with a bias+silu and a residual
    epilogue. The integer modes against the reference's camp_matmul under
    jit; the float modes against it run eagerly, as the reference engine
    runs them (under jit XLA keeps the dequantized bf16 weights in excess
    precision, which moves outputs by several bf16 ULPs)."""
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal((2, 5, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((64, 48)) * 0.1, jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(48), jnp.bfloat16)
    opd = jnp.asarray(rng.standard_normal((2, 5, 48)), jnp.bfloat16)
    jw = jcamp.prepare_weight(w, qmode)
    tw = from_jax_params(jax_to_numpy({"w": jw}), device="cpu")["w"]
    if qmode != "none":
        assert isinstance(tw, quant.QuantizedTensor)
        assert tw.bits == (4 if qmode.startswith("w4") else 8)
    tx, tb, to = (torch.from_numpy(to_numpy(a)).to(torch.bfloat16)
                  for a in (x, b, opd))
    integer = qmode in camp.INT_QMODES
    for epi, jkw, tkw in (("bias+silu", {"bias": b}, {"bias": tb}),
                          ("residual", {"operand": opd}, {"operand": to})):
        ref = functools.partial(jcamp.camp_matmul, qmode=qmode, fused=fused,
                                epilogue=epi)
        want = to_numpy((jax.jit(ref) if integer else ref)(x, jw, **jkw))
        got = to_numpy(camp.camp_matmul(tx, tw, qmode=qmode, fused=fused,
                                        epilogue=epi, **tkw))
        assert got.shape == (2, 5, 48)
        if integer and epi == "residual":
            np.testing.assert_array_equal(got, want)
        else:
            assert_ulps(got, want, 1, "bfloat16")

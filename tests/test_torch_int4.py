"""int4 CAMP in the port against the reference: packing, int4 weights, the
fused w4a8/w4a4 GEMM (K4) and the hybrid multiplier (the model and the
engine in w4a8/w4a4 are in test_torch_int4_serving.py).

The same numpy inputs go into the reference and into the port on the CPU.

Tolerances:
* pack/unpack, int4 weight quantization, the hybrid products: bit-exact.
* K4's plain version against the interpret-mode Pallas kernel and against
  the jitted ``ops.gemm_w4_fused``/``gemm_a4w4_fused(impl='xla')``: the
  int4/int8 activations and their scales are bit-exact (the port copies
  XLA's ``absmax * f32(1/qmax)``, for qmax 7 as for 127; measured on the
  CPU: jit and interpret-mode Pallas both multiply by the reciprocal), so
  outputs for none/bias/mul/residual are bit-exact in f32 and bf16.
  silu/gelu: ≤ 4 f32 ULPs, ≤ 1 bf16 ULP after the cast, at the larger of
  the output's and the pre-activation's magnitude (gelu's tanh form
  cancels in its negative tail; see test_torch_gemm.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hybrid as jhybrid  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.camp_gemm_fused import (camp_gemm_fused_w4a4,  # noqa: E402
                                           camp_gemm_fused_w4a8)
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import hybrid, quant  # noqa: E402
from repro_torch.kernels import camp_gemm_fused as k4  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_parity import (assert_ulps, jax_to_numpy,  # noqa: E402
                          pre_activation_epilogue, to_numpy)

# (M, K, N) of tests/test_fused_gemm.py: divisible, fully non-divisible,
# a 3-row decode panel; and its epilogues.
SHAPES = [(64, 128, 64), (50, 200, 72), (3, 96, 40)]
EPILOGUES = ["none", "bias", "silu", "gelu", "bias+silu", "residual", "mul",
             "bias+gelu+residual"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
INT4_MODES = ["w4a8", "w4a4"]
JAX_FUSED = {"w4a8": jops.gemm_w4_fused, "w4a4": jops.gemm_a4w4_fused}
PALLAS = {"w4a8": camp_gemm_fused_w4a8, "w4a4": camp_gemm_fused_w4a4}
PORT_REF = {"w4a8": k4.camp_gemm_fused_w4a8_ref,
            "w4a4": k4.camp_gemm_fused_w4a4_ref}


def test_pack_unpack_int4_exhaustive():
    """Every (low, high) pair of int4 values, plus a truncating unpack."""
    v = np.arange(-8, 8, dtype=np.int8)
    q = np.stack(np.meshgrid(v, v, indexing="ij")).reshape(2, -1)
    q = np.concatenate([q, q[::-1]], axis=0)            # (4, 256)
    want = np.asarray(jquant.pack_int4(jnp.asarray(q)))
    got = quant.pack_int4(torch.from_numpy(q))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(quant.unpack_int4(got).numpy(), q)
    np.testing.assert_array_equal(
        quant.unpack_int4(got, 3).numpy(),
        np.asarray(jquant.unpack_int4(jnp.asarray(want), 3)))
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4(torch.zeros(3, 2, dtype=torch.int8))


def test_quantize_weight_int4_bit_exact():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((96, 40)).astype(np.float32)
    w[:, 5] = 0.0                                        # zero column
    jw = jquant.quantize_weight(jnp.asarray(w), 4)
    tw = quant.quantize_weight(torch.from_numpy(w), 4)
    assert (tw.bits, tw.shape, tuple(tw.q.shape)) == (4, (96, 40), (48, 40))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    np.testing.assert_array_equal(tw.dequantize().numpy(),
                                  np.asarray(jw.dequantize()))
    carried = from_jax_params(jax_to_numpy({"w": jw}), device="cpu")["w"]
    assert (carried.bits, carried.shape) == (4, (96, 40))
    np.testing.assert_array_equal(carried.q.numpy(), tw.q.numpy())
    with pytest.raises(ValueError, match="payload"):
        quant.QuantizedTensor(q=tw.q, scale=tw.scale, bits=4, shape=(48, 40))


def test_rowwise_int4_eager_and_jitted_chains():
    """The reference has two f32 chains for ``absmax / 7``: eager
    (``core/quant.py``, a true division) and jitted (the fused fallback and
    the Pallas kernels, a multiplication by f32(1/7)). The port keeps one
    of each, bit-exact with its counterpart; on widely scaled rows the two
    chains give different scales."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((1000, 64))
         * rng.uniform(0.01, 100.0, (1000, 1))).astype(np.float32)
    x[3] = 0.0
    jq, js = jquant.quantize_rowwise(jnp.asarray(x), 4)
    tq, ts = quant.quantize_rowwise(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, jit_s = jax.jit(jref.quantize_rowwise_ref, static_argnums=1)(
        jnp.asarray(x), 4)
    tq, ts_jit = ref.quantize_rowwise_ref(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts_jit.numpy(), np.asarray(jit_s))
    assert (ts_jit != ts).any()


def _inputs(m, k, n, epilogue, dt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :7] = 0.0                      # some exact zeros
    x[-1] = 0.0                         # a zero row: scale 1
    w = rng.standard_normal((k, n)).astype(np.float32)
    wq = jquant.quantize_weight(jnp.asarray(w), 4)
    jdt, tdt = DTYPES[dt]

    def pair(shape, needed):
        if not needed:
            return None, None
        ja = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jdt)
        return ja, torch.from_numpy(to_numpy(ja)).to(tdt)

    jb, tb = pair(n, "bias" in epilogue)
    jo, to = pair((m, n), "mul" in epilogue or "residual" in epilogue)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(to_numpy(jx)).to(tdt)
    return (jx, wq, jb, jo), (tx, torch.from_numpy(np.array(wq.q)),
                              torch.from_numpy(np.array(wq.scale)), tb, to)


def _compare(got, want, epilogue, dt, pre):
    if pre is None:
        np.testing.assert_array_equal(got, want)
    else:
        assert_ulps(got, want, 4 if dt == "float32" else 1, dt, scale=pre)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("qmode", INT4_MODES)
def test_k4_plain_matches_jitted_reference(qmode, shape, epilogue, dt):
    m, k, n = shape
    (jx, wq, jb, jo), (tx, tq, ts, tb, to) = _inputs(m, k, n, epilogue, dt,
                                                     seed=m * 7 + k)
    jdt, tdt = DTYPES[dt]

    def ref(epi):
        return to_numpy(JAX_FUSED[qmode](
            jx, wq.q, wq.scale, out_dtype=jdt, impl="xla", epilogue=epi,
            bias=jb if "bias" in epi else None,
            operand=jo if ("mul" in epi or "residual" in epi) else None))

    got = to_numpy(PORT_REF[qmode](tx, tq, ts, out_dtype=tdt,
                                   epilogue=epilogue, bias=tb, operand=to))
    pre = pre_activation_epilogue(epilogue)
    _compare(got, ref(epilogue), epilogue, dt, None if pre is None
             else ref(pre))
    # the dispatch and the wrapper take the same plain version on the CPU
    via_ops = {"w4a8": ops.gemm_w4_fused, "w4a4": ops.gemm_a4w4_fused}[qmode]
    np.testing.assert_array_equal(
        to_numpy(via_ops(tx, tq, ts, out_dtype=tdt, epilogue=epilogue,
                         bias=tb, operand=to)), got)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("qmode", INT4_MODES)
def test_k4_plain_matches_interpret_pallas_kernel(qmode, shape, epilogue):
    m, k, n = shape
    (jx, wq, jb, jo), (tx, tq, ts, tb, to) = _inputs(
        m, k, n, epilogue, "float32", seed=m * 11 + k)
    want = to_numpy(PALLAS[qmode](jx, wq.q, wq.scale, block_m=32, block_n=32,
                                  block_k=64, epilogue=epilogue, bias=jb,
                                  operand=jo, interpret=True))
    got = to_numpy(PORT_REF[qmode](tx, tq, ts, epilogue=epilogue, bias=tb,
                                   operand=to))
    pre = pre_activation_epilogue(epilogue)
    if pre is not None:
        pre = to_numpy(PORT_REF[qmode](
            tx, tq, ts, epilogue=pre, bias=tb if "bias" in pre else None,
            operand=to if "residual" in pre else None))
    _compare(got, want, epilogue, "float32", pre)


def test_k4_rejects_odd_k_and_mismatched_weight():
    x = torch.randn(2, 7)
    w = torch.zeros(3, 4, dtype=torch.int8)
    for fn in (k4.camp_gemm_fused_w4a8, k4.camp_gemm_fused_w4a4):
        with pytest.raises(ValueError, match="even"):
            fn(x, w, torch.ones(1, 4))
        with pytest.raises(ValueError, match="rows"):
            fn(torch.randn(2, 8), w, torch.ones(1, 4))


def test_hybrid_i8_exhaustive_scalar_square():
    """The paper's §3 identity over every int8 × int8 pair, as the
    reference's (tests/test_kernels.py)."""
    a = np.arange(-128, 128, dtype=np.int8).reshape(-1, 1)
    b = np.arange(-128, 128, dtype=np.int8).reshape(1, -1)
    got = hybrid.hybrid_matmul_i8(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int32) @ b.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jhybrid.hybrid_matmul_i8(jnp.asarray(a), jnp.asarray(b))))
    hi, lo = hybrid.split_nibbles(torch.from_numpy(a[:, 0]))
    jhi, jlo = jhybrid.split_nibbles(jnp.asarray(a[:, 0]))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))


def test_hybrid_w4a8_exhaustive():
    a = np.arange(-128, 128, dtype=np.int8).reshape(-1, 1)
    b = np.arange(-8, 8, dtype=np.int8).reshape(1, -1)
    got = hybrid.hybrid_matmul_w4a8(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int32) @ b.astype(np.int32))


@pytest.mark.parametrize("qmode", ["w8a8", "w4a8", "w4a4"])
def test_impl_hybrid_equals_torch(qmode):
    """impl='hybrid' keeps its meaning (the reference's ops.py): bit-exact
    with the plain product, fused and unfused."""
    from repro_torch.core import camp
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    w = camp.prepare_weight(
        torch.from_numpy(rng.standard_normal((64, 24)).astype(np.float32)),
        qmode)
    for fused in (True, False):
        want = camp.camp_matmul(x, w, qmode=qmode, fused=fused, impl="torch")
        got = camp.camp_matmul(x, w, qmode=qmode, fused=fused, impl="hybrid")
        assert torch.equal(got, want)

"""A CPU model of the fused prologue of K1's and K4's tensor-core kernel
(``src/repro_torch/csrc/camp_gemm_tc.cuh`` with float x), held bit for bit
against the jitted reference (``repro.kernels.ops.gemm_i8_fused`` /
``gemm_w4_fused`` / ``gemm_a4w4_fused`` with ``impl='xla'`` under
``jax.jit``, as ``tests/test_torch_gemm.py`` and ``test_torch_int4.py`` run
them).

The kernel cannot run here, so this model does, in PyTorch and numpy's
float32, what it does on the card, in its order:

* the scale pass over each whole row: ``absmax * f32(1/qmax)`` (1 where the
  row is zero), and its reciprocal rounded to f32 (``__frcp_rn``); the
  scales land in the workspace for the flush;
* x quantized per K step in 16-byte groups (8 bf16 or 4 f32 values): the
  exact product with the reciprocal rounded to an integer (an fma with
  1.5 * 2^23), with the division (``__fdiv_rn``, ``rintf``, the clamp) for
  any group with a product within 2^-14 of a half-integer, and for every
  group in the split-scale control; each group stored by the thread that
  the kernel assigns it, at the address of the 128-byte swizzle
  (``swz_off``) that the wgmma descriptors read;
* B and the products as ``test_torch_gemm_tiles.model`` has them: the
  int32 partial sums per split, summed in split order;
* the flush (``kernels/ref.py::flush_ref``) with the workspace's scales.

The model's output must equal the reference bit for bit in w8a8, w4a8 and
w4a4, bf16 and f32, at the six serving shapes and the ragged ones. Two
controls must miss it: each split's scale taken from its own K range only
(the kernel's ``kSplitScales``, which chip_smoke.py launches), and the
last split dropped. The division-free rounding is held against the
division on quotients placed next to half-integers.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.blocking import (SCALE_KERNEL, TC_BK,  # noqa: E402
                                       split_plan, tc_flags)
from repro_torch.kernels.ref import flush_ref, recip_f32  # noqa: E402
from test_torch_gemm_tiles import (EPILOGUE, RAGGED_SHAPES,  # noqa: E402
                                   SERVING_SHAPES, SMS, model, swz_off)
from torch_parity import to_numpy  # noqa: E402

BK = TC_BK                       # K a step: 128 int8 a row
THREADS = 256
NEAR_HALF = np.float32(0.49993896484375)     # 1/2 - 2^-14
QMODES = {"w8a8": (127, False), "w4a8": (127, True), "w4a4": (7, True)}
JAX_FUSED = {"w8a8": jops.gemm_i8_fused, "w4a8": jops.gemm_w4_fused,
             "w4a4": jops.gemm_a4w4_fused}
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16, 2),
          "float32": (jnp.float32, torch.float32, 4)}


# -- the kernel's arithmetic ------------------------------------------------
def clamp_rint(quotient, qmax):
    """fminf(fmaxf(rintf(q), -qmax), qmax) as int8: fmaxf and fminf take
    the other operand where one is NaN, as on the card."""
    q = np.float32(qmax)
    return np.fmin(np.fmax(np.rint(quotient.astype(np.float32)), -q),
                   q).astype(np.int8)


def row_scales(x32, qmax, lo=0, hi=None):
    """(scale, its f32 reciprocal) of each row from x32[:, lo:hi]."""
    amax = np.abs(x32[:, lo:hi]).max(axis=1, initial=np.float32(0))
    s = np.where(amax == 0, np.float32(1), amax * np.float32(recip_f32(qmax)))
    s = s.astype(np.float32)
    with np.errstate(divide="ignore", over="ignore"):
        r = (np.float32(1) / s).astype(np.float32)
    return s, r


def quantize_groups(v, s, r, qmax, exact=False):
    """int8 of v (rows, groups, values a group) in f32 with row scale s and
    reciprocal r (rows,), and how many groups took the division: the exact
    product p = v r (f64 holds it), n = rint(p) (the fma with 1.5 * 2^23),
    p - n; the division where any |p - n| > 1/2 - 2^-14 or p is not finite,
    in rows whose r is 0 or infinite, and everywhere with ``exact`` (the
    split-scale control, whose scales do not bound the row)."""
    s3, r3 = s[:, None, None], r[:, None, None]
    with np.errstate(over="ignore", invalid="ignore"):
        p = v.astype(np.float64) * r3.astype(np.float64)
        n = np.rint(p)
        near = np.abs(p - n)
    fast = np.nan_to_num(n, nan=0, posinf=0, neginf=0).astype(np.int64) & 0xFF
    fast = ((fast ^ 0x80) - 0x80).astype(np.int8)
    ok_row = (r3[..., 0] > 0) & (r3[..., 0] <= np.finfo(np.float32).max)
    with np.errstate(invalid="ignore"):
        slow_g = ~((near <= NEAR_HALF).all(axis=2) & ok_row) | exact
    with np.errstate(divide="ignore", invalid="ignore"):
        want = clamp_rint(v / s3, qmax)
    out = np.where(slow_g[..., None], want, fast)
    return out, int(slow_g.sum())


def quantize_rows(x32, s, r, qmax, xb, exact=False):
    """x32 (M, K) → int8 (M, K) in the kernel's 16-byte groups (16 / xb
    values; the last group of a row zero-filled past K)."""
    m, k = x32.shape
    kpg = 16 // xb
    kp = -(-k // kpg) * kpg
    v = np.zeros((m, kp), np.float32)
    v[:, :k] = x32
    q, _ = quantize_groups(v.reshape(m, kp // kpg, kpg), s, r, qmax, exact)
    return q.reshape(m, kp)[:, :k]


def writer_map(mt, xb):
    """Which (thread, j) stores each byte of a step's A tile: (mt, 128)
    thread * 256 + j, from the kernel's group g = thread + THREADS j; every
    byte exactly once, at the group's swizzled address."""
    kpg = 16 // xb
    gpr = BK // kpg
    g = np.arange(mt * gpr)
    r, col = g // gpr, (g % gpr) * kpg
    owner = np.full((mt, BK), -1, np.int64)
    addr = np.full((mt, BK), -1, np.int64)
    for e in range(kpg):
        assert (owner[r, col + e] == -1).all()
        owner[r, col + e] = (g % THREADS) * THREADS + g // THREADS
        addr[r, col + e] = swz_off(torch.from_numpy(r),
                                   torch.from_numpy(col)).numpy() + e
    assert (owner >= 0).all()
    rows, cols = np.meshgrid(np.arange(mt), np.arange(BK), indexing="ij")
    assert (addr == swz_off(torch.from_numpy(rows),
                            torch.from_numpy(cols)).numpy()).all()
    return owner


def fused_model(x32, b, qmode, xb, plan=None, split_scales=False):
    """The kernel's int32 sums (M, N) and the scales the flush reads."""
    qmax, w4 = QMODES[qmode]
    m, k = x32.shape
    n = b.shape[1]
    mt, splits, per = plan or split_plan(m, n, k, SMS)
    if not split_scales:
        s, r = row_scales(x32, qmax)
        a_q = quantize_rows(x32, s, r, qmax, xb)
        acc, _ = model(torch.from_numpy(a_q), torch.from_numpy(b), m, k, n,
                       w4, plan=(mt, splits, per))
        return acc, s
    # the control: every split quantizes its own K range with a scale from
    # that range alone; the flush reads split 0's (the block that writes
    # the workspace's scales). The ranges are disjoint and every group of
    # the control takes the division (elementwise), so the quantized
    # ranges side by side go through the model once: the split-ordered
    # int32 sums of the per-range products are that one product's.
    a_q = np.zeros((m, k), np.int8)
    for z in range(splits):
        lo, hi = z * per * BK, min(k, (z + 1) * per * BK)
        if lo >= k:
            continue
        s_z, r_z = row_scales(x32, qmax, lo, hi)
        if z == 0:
            s = s_z
        a_q[:, lo:hi] = quantize_rows(x32[:, lo:hi], s_z, r_z, qmax, xb,
                                      exact=True)
    acc, _ = model(torch.from_numpy(a_q), torch.from_numpy(b), m, k, n, w4,
                   plan=(mt, splits, per))
    return acc, s


# -- inputs and the reference -----------------------------------------------
def inputs(m, k, n, qmode, dt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0, :5] = 0.0
    if m > 2:
        x[2] = 0.0                            # a zero row: scale 1
    w = rng.standard_normal((k, n)).astype(np.float32)
    wq = jquant.quantize_weight(jnp.asarray(w), 4 if QMODES[qmode][1] else 8)
    bias = rng.standard_normal(n).astype(np.float32)
    jdt = DTYPES[dt][0]
    jx = jnp.asarray(x, jdt)
    return jx, wq, jnp.asarray(bias, jdt)


@functools.lru_cache(maxsize=None)
def jitted(qmode, out_dtype, epilogue):
    """The jitted reference GEMM, one a (qmode, dtype, epilogue): JAX
    keeps its compiled shapes, so a case another test compiled is not
    compiled again."""
    return jax.jit(functools.partial(JAX_FUSED[qmode], impl="xla",
                                     out_dtype=out_dtype, epilogue=epilogue))


def reference(qmode, jx, wq, jbias, epilogue):
    run = jitted(qmode, jx.dtype, epilogue)
    return to_numpy(run(jx, wq.q, wq.scale,
                        bias=jbias if epilogue == "bias" else None))


def flushed(acc, s, wq, jbias, epilogue, tdt):
    tb = (torch.from_numpy(to_numpy(jbias)).to(tdt)
          if epilogue == "bias" else None)
    return to_numpy(flush_ref(acc, torch.from_numpy(s)[:, None],
                              torch.from_numpy(to_numpy(wq.scale)),
                              out_dtype=tdt, epilogue=epilogue, bias=tb))


def case(shape, qmode, dt):
    m, k, n = shape
    jx, wq, jbias = inputs(m, k, n, qmode, dt, seed=m + k + n)
    return jx, wq, jbias, to_numpy(jx), np.array(wq.q)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("qmode", list(QMODES))
@pytest.mark.parametrize("shape", SERVING_SHAPES + RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_model_equals_jitted_reference(shape, qmode, dt):
    jx, wq, jbias, x32, b = case(shape, qmode, dt)
    m, k, n = shape
    mt = split_plan(m, n, k, SMS)[0]
    writer_map(mt, DTYPES[dt][2])
    acc, s = fused_model(x32, b, qmode, DTYPES[dt][2])
    epi = EPILOGUE.get(shape, "none")
    np.testing.assert_array_equal(
        flushed(acc, s, wq, jbias, epi, DTYPES[dt][1]),
        reference(qmode, jx, wq, jbias, epi))


@pytest.mark.parametrize("control", ["split_scales", "dropped_split"])
@pytest.mark.parametrize("qmode", list(QMODES))
@pytest.mark.parametrize("shape", [(8, 4864, 896), (256, 4864, 896)],
                         ids=lambda s: "x".join(map(str, s)))
def test_controls_miss_the_reference(shape, qmode, control):
    """A scale from each split's own K range, or the last split left out
    (splits - 1 runs of the plan's length, as chip_smoke's control launches
    the kernel), misses the reference."""
    jx, wq, jbias, x32, b = case(shape, qmode, "bfloat16")
    m, k, n = shape
    mt, splits, per = split_plan(m, n, k, SMS)
    assert splits > 1
    if control == "split_scales":
        acc, s = fused_model(x32, b, qmode, 2, split_scales=True)
    else:
        acc, s = fused_model(x32, b, qmode, 2, plan=(mt, splits - 1, per))
    got = flushed(acc, s, wq, jbias, "none", torch.bfloat16)
    assert not np.array_equal(got, reference(qmode, jx, wq, jbias, "none"))


@pytest.mark.parametrize("qmax", [127, 7])
def test_rounding_without_division_is_exact(qmax):
    """The exact product with the reciprocal, rounded by the magic constant,
    with the division for groups near a half-integer, equals
    clamp(rint(fl(v / s))) on rows whose scale comes from their own absmax
    (the kernel's precondition: |v| <= absmax), with quotients placed
    within a few ULPs of every half-integer, at +-absmax, at random, in
    zero rows and in rows of subnormal values; and the division is rare on
    random values."""
    rng = np.random.default_rng(qmax)
    rows, groups = 512, 64
    amax = (rng.uniform(0.5, 1.0, rows) * np.exp2(rng.integers(-20, 20, rows))
            ).astype(np.float32)
    amax[:3] = [np.float32(2.0 ** -140), np.float32(1e-45), np.float32(3e38)]
    half = rng.integers(-qmax, qmax, (rows, groups, 8)) + 0.5
    s, _ = row_scales(amax[:, None], qmax)
    v = (half * s[:, None, None]).astype(np.float32)
    # nudged by -3..3 ULPs (zeros stay zero), inside +-absmax
    bits = v.view(np.int32) + np.where(
        v != 0, rng.integers(-3, 4, v.shape), 0).astype(np.int32)
    v = np.clip(bits.view(np.float32), -amax[:, None, None],
                amax[:, None, None])
    v[:, 0, :4] = amax[:, None]
    v[:, 0, 4:] = -amax[:, None]
    v[:, 1:8] = (rng.uniform(-1, 1, (rows, 7, 8))
                 * amax[:, None, None]).astype(np.float32)
    v[3] = 0.0                                     # a zero row
    s, r = row_scales(v.reshape(rows, -1), qmax)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        want = clamp_rint(v / s[:, None, None], qmax)
    got, slow = quantize_groups(v, s, r, qmax)
    np.testing.assert_array_equal(got, want)
    assert slow > rows * (groups - 8) // 2     # the ties took the division
    rand = (rng.uniform(-1, 1, (rows, groups, 8)) * amax[4:5, None, None]
            ).astype(np.float32)
    s, r = row_scales(rand.reshape(rows, -1), qmax)
    got, slow = quantize_groups(rand, s, r, qmax)
    np.testing.assert_array_equal(
        got, clamp_rint(rand / s[:, None, None], qmax))
    assert slow < rows * groups // 100


@pytest.mark.parametrize("shape", SERVING_SHAPES + ((17, 896, 896),
                                                    (4096, 896, 4864)),
                         ids=lambda s: "x".join(map(str, s)))
def test_flags(shape):
    """One split on a grid that fills the card flushes in the product
    block; the fused calls of row tiles 32 and 128 take the scale pass,
    those of 8 reduce their rows in the block."""
    m, k, n = shape
    plan = split_plan(m, n, k, SMS)
    flags = tc_flags(m, n, plan, SMS, True)
    blocks = -(-n // 128) * -(-m // plan[0])
    assert bool(flags & 1) == (plan[1] == 1 and blocks >= SMS)
    assert bool(flags & SCALE_KERNEL) == (plan[0] in (32, 128))
    assert not tc_flags(m, n, plan, SMS, False) & SCALE_KERNEL

"""K2 (paged prefill) and K3 (paged decode) plain versions against the
reference's jitted XLA references and its interpret-mode Pallas kernels.

Tolerance, f32 outputs: atol = rtol = 1e-5 — the same math as the
reference in another summation order (dot products over hd, the softmax
sum); the reference's own kernel-vs-reference tests use the same bound.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention as jpa  # noqa: E402
from repro.kernels.paged_attention import \
    paged_attention_reference as jpa_ref  # noqa: E402
from repro.kernels.paged_prefill import \
    paged_prefill_attention as jpp  # noqa: E402
from repro.kernels.paged_prefill import \
    paged_prefill_reference as jpp_ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import paged_prefill as pp  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _pages(rng, kv, ps, hd, num_pages):
    kp = rng.integers(-127, 128, (num_pages, kv, ps, hd)).astype(np.int8)
    vp = rng.integers(-127, 128, (num_pages, kv, ps, hd)).astype(np.int8)
    ks = rng.uniform(1e-3, 5e-2, (num_pages, kv, ps)).astype(np.float32)
    vs = rng.uniform(1e-3, 5e-2, (num_pages, kv, ps)).astype(np.float32)
    return kp, vp, ks, vs


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


@pytest.mark.parametrize("b,kv,g,hd,ps,mp", [
    (3, 2, 3, 64, 16, 4),     # GQA
    (2, 1, 4, 32, 8, 5),      # MQA
    (1, 4, 1, 128, 16, 2),    # MHA
    (8, 2, 7, 64, 16, 6),     # qwen2-0.5b head layout
])
def test_paged_decode_matches_reference(b, kv, g, hd, ps, mp):
    rng = np.random.default_rng(b * 100 + hd)
    kp, vp, ks, vs = _pages(rng, kv, ps, hd, 32 + b * mp)
    tables = rng.permutation(32 + b * mp)[:b * mp].reshape(b, mp) \
        .astype(np.int32)
    lengths = rng.integers(1, mp * ps + 1, (b,)).astype(np.int32)
    lengths[0] = ps                        # exact page boundary
    lengths[-1] = 1                        # a single cached token
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    j, t = _both(q, kp, vp, ks, vs, tables, lengths)
    want = np.asarray(jax.jit(jpa_ref)(*j))
    got = pa.paged_attention(*t).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ker = np.asarray(jpa(*j, impl="pallas", interpret=True))
    np.testing.assert_allclose(got, ker, **TOL)


@pytest.mark.parametrize("kv,g,hd,ps,ppstep,c,q_start", [
    (2, 3, 64, 16, 1, 16, 32),     # GQA, one page per step
    (2, 2, 32, 8, 4, 12, 24),      # multi-page steps, unaligned chunk end
    (1, 4, 16, 8, 2, 5, 0),        # MQA, chunk == whole (short) prompt
    (4, 1, 32, 16, 8, 32, 16),     # MHA, pages_per_step > n_pages
    (2, 7, 64, 16, 2, 9, 21),      # unaligned q_start (mid-page resume)
])
def test_paged_prefill_matches_reference(kv, g, hd, ps, ppstep, c, q_start):
    rng = np.random.default_rng(kv * 1000 + c + q_start)
    mp = -(-(q_start + c) // ps) + 2
    kp, vp, ks, vs = _pages(rng, kv, ps, hd, 64)
    table = rng.permutation(64)[:mp].astype(np.int32)
    q = rng.standard_normal((kv, c, g, hd)).astype(np.float32)
    j, t = _both(q, kp, vp, ks, vs, table)
    want = np.asarray(jax.jit(jpp_ref, static_argnames="q_start")(
        *j, q_start=q_start))
    got = pp.paged_prefill_attention(*t, q_start=q_start,
                                     pages_per_step=ppstep).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ker = np.asarray(jpp(*j, q_start=q_start, pages_per_step=ppstep,
                         impl="pallas", interpret=True))
    np.testing.assert_allclose(got, ker, **TOL)


def test_bf16_queries_keep_dtype():
    """bf16 q gives bf16 output, computed in f32 inside (as the reference)."""
    rng = np.random.default_rng(9)
    kp, vp, ks, vs = _pages(rng, 2, 8, 16, 8)
    tables = np.arange(4, dtype=np.int32).reshape(2, 2)
    lengths = np.array([5, 16], np.int32)
    q = rng.standard_normal((2, 2, 2, 16)).astype(np.float32)
    j, t = _both(q, kp, vp, ks, vs, tables, lengths)
    want = np.asarray(jpa_ref(j[0].astype(jnp.bfloat16), *j[1:]),
                      np.float32)
    got = pa.paged_attention(t[0].to(torch.bfloat16), *t[1:])
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-5)


def _float_pages(rng, kv, ps, hd, num_pages):
    return [rng.standard_normal((num_pages, kv, ps, hd)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("impl", ["auto", "torch", "cuda"])
def test_float_pages_take_plain_version(impl):
    """Float pages (scales None) take the plain versions, as in the
    reference, whose Pallas kernels read int8 pages only: decode and
    prefill match the reference's wrappers; ``impl='cuda'`` raises."""
    rng = np.random.default_rng(11)
    kv, g, hd, ps = 2, 3, 32, 8
    kp, vp = _float_pages(rng, kv, ps, hd, 12)
    tables = np.arange(8, dtype=np.int32).reshape(2, 4)
    lengths = np.array([29, 8], np.int32)
    q = rng.standard_normal((2, kv, g, hd)).astype(np.float32)
    qc = rng.standard_normal((kv, 10, g, hd)).astype(np.float32)
    j, t = _both(q, kp, vp, tables, lengths, qc)
    if impl == "cuda":
        with pytest.raises(ValueError, match="int8 pages only"):
            pa.paged_attention(t[0], t[1], t[2], None, None, t[3], t[4],
                               impl=impl)
        with pytest.raises(ValueError, match="int8 pages only"):
            pp.paged_prefill_attention(t[5], t[1], t[2], None, None, t[3][0],
                                       q_start=13, impl=impl)
        return
    want = np.asarray(jpa(j[0], j[1], j[2], None, None, j[3], j[4]))
    got = pa.paged_attention(t[0], t[1], t[2], None, None, t[3], t[4],
                             impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want = np.asarray(jpp(j[5], j[1], j[2], None, None, j[3][0], q_start=13))
    got = pp.paged_prefill_attention(t[5], t[1], t[2], None, None, t[3][0],
                                     q_start=13, impl=impl).numpy()
    np.testing.assert_allclose(got, want, **TOL)

"""K8 (dense flash attention): the port's plain version against the
reference's Pallas kernel in interpret mode, on the same numpy inputs.

* The reference test's grid (tests/test_kernels.py:148-150: three shapes ×
  causal/non-causal × three block pairs), f32, rtol = atol = 2e-5: both run
  the same blockwise online softmax in f32, and differ only in summation
  order (a few f32 ULPs).
* The bf16 case of tests/test_kernels.py:166 at 5e-2, the reference test's
  own tolerance (p is rounded to bf16 before the PV product, and the output
  is bf16: one bf16 ULP at |out| ≈ 2 is 1.6e-2).
* An S that no block divides: both halve their blocks (S = 48, block 32 →
  16). The CUDA kernel masks a ragged last tile instead; chip_smoke.py
  phase 5 checks that on the card at S = 777 and 1,000, with head dims 8,
  16, 32 and 256.
* ``attention_ref`` (the naive oracle) against the reference's.
* ``impl='cuda'`` on CPU tensors raises and counts no launch.
* The wrapper's ``check_inputs`` takes head dims that are multiples of 8 up
  to 256 (stablelm-12b's 160 among them) and refuses 12, 264, a
  non-contiguous, misaligned, float16 or mixed-dtype input; the plain
  version at hd 160 and 256 against the reference's kernel, f32 2e-5.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` phase 5
holds it against the plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import flash_attention as k8  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from torch_parity import to_numpy  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 5e-2


def _qkv(rng, shape, dtype=np.float32):
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("shape", [(1, 32, 8), (4, 64, 16), (2, 128, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(16, 16), (32, 16), (64, 64)])
def test_plain_matches_interpret_kernel(shape, causal, blocks):
    bq, bk = blocks
    q, k, v = _qkv(np.random.default_rng(7), shape)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=bq, block_k=bk, interpret=True)
    got = k8.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, block_q=bq,
                             block_k=bk, impl="torch")
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_bf16_matches_interpret_kernel_and_oracle():
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, (2, 64, 16))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_flash(jq, jk, jv, causal=True, block_q=16, block_k=16,
                     interpret=True)
    oracle = jref.attention_ref(jq[None], jk[None], jv[None], causal=True)[0]
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = k8.flash_attention(tq, tk, tv, causal=True, block_q=16, block_k=16,
                             impl="torch")
    assert got.dtype == torch.bfloat16
    for ref in (want, oracle):
        np.testing.assert_allclose(to_numpy(got), to_numpy(ref),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_halves_blocks_like_the_reference(causal):
    """S = 48: block 32 divides nothing, both packages block by 16."""
    q, k, v = _qkv(np.random.default_rng(11), (3, 48, 16))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=32, block_k=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = k8.flash_attention(tq, tk, tv, causal=causal, block_q=32,
                             block_k=32, impl="auto")
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)
    oracle = attention_ref(tq[None], tk[None], tv[None], causal=causal)[0]
    np.testing.assert_allclose(to_numpy(got), to_numpy(oracle),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq", [16, 24])
def test_attention_ref_matches_reference_oracle(causal, sq):
    """(B, H, Sq, D) against Sk = 24 keys: the causal mask keeps column c
    for row r when c <= r + Sk - Sq, in both oracles."""
    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, 24, 16)).astype(np.float32)
            for _ in range(2))
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    got = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_cuda_impl_on_cpu_raises_and_counts_nothing():
    q = torch.zeros(1, 16, 8)
    before = k8.launches
    with pytest.raises(ValueError):
        k8.flash_attention(q, q, q, impl="cuda")
    with pytest.raises(ValueError):
        k8.flash_attention(q, q, q, impl="xla")
    # the wrapper takes the plain version for a CPU tensor, and counts none
    k8.flash_attention_cuda(q, q, q)
    assert k8.launches == before


@pytest.mark.parametrize("d", [8, 16, 64, 128, 136, 160, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_check_inputs_takes_head_dims_up_to_256(d, dtype):
    """Multiples of 8 up to MAX_HEAD_DIM, stablelm-12b's 160 among them."""
    q = torch.zeros(2, 24, d, dtype=getattr(torch, dtype))
    k8.check_inputs(q, q.clone(), q.clone())
    assert k8.MAX_HEAD_DIM == 256


@pytest.mark.parametrize("case", ["d12", "d264", "non_contiguous",
                                  "mixed_dtype", "float16", "misaligned"])
def test_check_inputs_rejects(case):
    q = torch.zeros(2, 24, 64)
    k = v = q.clone()
    if case == "d12":
        q = k = v = torch.zeros(2, 24, 12)
    elif case == "d264":
        q = k = v = torch.zeros(2, 24, 264)
    elif case == "non_contiguous":
        k = torch.zeros(2, 64, 24).transpose(1, 2)
    elif case == "mixed_dtype":
        v = v.bfloat16()
    elif case == "float16":
        q = k = v = q.half()
    elif case == "misaligned":
        k = torch.zeros(2 * 24 * 64 + 2)[2:].view(2, 24, 64)
    with pytest.raises(ValueError):
        k8.check_inputs(q, k, v)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_interpret_kernel_at_wide_heads(d, causal):
    """stablelm-12b's hd 160 and the widest build's 256, which the kernel
    refused before; the plain version against the reference's kernel."""
    q, k, v = _qkv(np.random.default_rng(d), (2, 64, d))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, block_q=32, block_k=32, interpret=True)
    got = k8.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, block_q=32,
                             block_k=32, impl="torch")
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)

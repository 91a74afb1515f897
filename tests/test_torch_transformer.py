"""Forward logits of the port against the reference, on the reduced
qwen2-0.5b, with the reference's own weights carried across.

The reference engine runs ``forward`` eagerly (only its fused GEMM
fallback is jitted), so that is the comparison here. Eager JAX rounds to
bf16 after every op, as PyTorch does; a jitted forward lets XLA keep
excess precision across fused bf16 ops and moves logits by up to ~2% of
max |logit| at this size, which would hide the port's own faults.

Tolerance: 1% of max |logit|. The logits are bf16, so any difference is
at least one bf16 ULP of a logit, and one ULP of the largest logit is up to
2^-7 ≈ 0.78% of it. The differences come from f32 reduction orders
(rms_norm variance, softmax, attention sums) that can flip the bf16
rounding of an activation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import quantize_params as jax_quantize_params  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.spec_decode import \
    paged_chunk_forward as jax_chunk_forward  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.spec_decode import paged_chunk_forward  # noqa: E402
from torch_parity import jax_to_numpy, to_numpy  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

REL_TOL = 1e-2
AUX_RTOL = 1e-3
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")


def _pair(arch):
    """(jax cfg, port cfg, {qmode: (jax params, port params)}) for the
    reduced ``arch``, the reference's weights carried across."""
    jcfg = jax_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    out = {}
    for qmode in ("none", "w8a8"):
        jq = jax_quantize_params(jp, jcfg, qmode)
        out[qmode] = (jq, from_jax_params(jax_to_numpy(jq), device="cpu"))
    return jcfg, cfg, out


@pytest.fixture(scope="module")
def models():
    return _pair("qwen2-0.5b")


@pytest.fixture(scope="module")
def moe_models():
    """Reduced moonshot-v1-16b-a3b (MoE every layer, top-2 of 4) and
    llama4-maverick-400b-a17b (dense and MoE layers interleaved, top-1)."""
    return {arch: _pair(arch) for arch in MOE_ARCHS}


def assert_logits_close(got, want, what):
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, what
    tol = REL_TOL * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max |Δlogit| {err} > {tol}"


@pytest.mark.parametrize("qmode", ["none", "w8a8"])
def test_forward_no_cache(models, qmode):
    jcfg, cfg, params = models
    jq, tq = params[qmode]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    want, _, _ = jax_forward(jq, jcfg, jnp.asarray(toks), qmode=qmode)
    got, caches, aux = forward(tq, cfg, torch.from_numpy(toks), qmode=qmode)
    assert caches is None and float(aux) == 0.0      # no MoE layer
    assert_logits_close(got, want, f"{qmode} no-cache")
    last, _, _ = forward(tq, cfg, torch.from_numpy(toks), qmode=qmode,
                         last_logits_only=True)
    np.testing.assert_array_equal(to_numpy(last), to_numpy(got)[:, -1:])
    hidden, _, _ = forward(tq, cfg, torch.from_numpy(toks), qmode=qmode,
                           return_hidden=True)
    assert hidden.shape == (2, 24, cfg.d_model)


@pytest.mark.parametrize("qmode", ["none", "w8a8"])
def test_forward_paged_prefill_then_decode(models, qmode):
    """Two prefill chunks (page-aligned, then a partial page) and two
    ragged decode steps over two sequences, through both pools."""
    paged_prefill_then_decode(*models, qmode)


@pytest.mark.parametrize("qmode", ["none", "w8a8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(moe_models, arch, qmode):
    """Logits within the forward tolerance and the summed load-balance
    aux within ``AUX_RTOL``: the routers read bf16 hidden states that f32
    reduction orders upstream may move by a bf16 ULP (2^-8 relative),
    which moves mean gates by about 1e-4 (seen: 1.9e-4, llama4, none)."""
    jcfg, cfg, params = moe_models[arch]
    jq, tq = params[qmode]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24))
    want, _, jaux = jax_forward(jq, jcfg, jnp.asarray(toks), qmode=qmode)
    got, caches, aux = forward(tq, cfg, torch.from_numpy(toks), qmode=qmode)
    assert caches is None
    assert_logits_close(got, want, f"{arch} {qmode}")
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(jaux)) <= AUX_RTOL * float(jaux)
    assert float(aux) > 0.5 * sum(cfg.ffn_of(i) == "moe"
                                  for i in range(cfg.n_layers))


@pytest.mark.parametrize("qmode", ["none", "w8a8"])
def test_moe_forward_paged_prefill_then_decode(moe_models, qmode):
    """Reduced moonshot through the paged pools: MoE routing over each
    prefill chunk and over the two-sequence decode batch."""
    paged_prefill_then_decode(*moe_models["moonshot-v1-16b-a3b"], qmode)


def paged_prefill_then_decode(jcfg, cfg, params, qmode):
    jq, tq = params[qmode]
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "qmode": qmode})
    cfg = cfg.__class__(**{**cfg.__dict__, "qmode": qmode})
    ps, lens = 8, (13, 13)
    kw = dict(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.hd, num_pages=16, page_size=ps)
    jpool = jkv.PagePool(**kw, quantized=True)
    tpool = tkv.PagePool(**kw, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    nxt = []
    for sid, prompt in enumerate(prompts):
        jpool.reserve(sid, len(prompt) + 4)
        tpool.reserve(sid, len(prompt) + 4)
        for start, stop in ((0, 8), (8, len(prompt))):
            chunk = prompt[start:stop]
            want = jax_chunk_forward(jq, jcfg, jpool, sid, chunk, start,
                                     logits="all")
            got = paged_chunk_forward(tq, cfg, tpool, sid, chunk, start,
                                      logits="all")
            assert_logits_close(got, want, f"{qmode} seq {sid} chunk {start}")
        nxt.append(int(np.argmax(to_numpy(want)[0, -1])))
    for step in range(2):
        sids = [0, 1]
        jt, jl = jpool.batch_tables(sids)
        tt, tl = tpool.batch_tables(sids)
        toks = np.asarray(nxt, np.int64)[:, None]
        want, jnew, _ = jax_forward(
            jq, jcfg, jnp.asarray(toks), positions=jl[:, None],
            caches=[{"attn": jpool.layer_cache(i, jt, jl)}
                    for i in range(cfg.n_layers)])
        got, tnew, _ = forward(
            tq, cfg, torch.from_numpy(toks), positions=tl[:, None].long(),
            caches=[{"attn": tpool.layer_cache(i, tt, tl)}
                    for i in range(cfg.n_layers)])
        assert_logits_close(got, want, f"{qmode} decode step {step}")
        for i in range(cfg.n_layers):
            jpool.writeback(i, jnew[i]["attn"])
            tpool.writeback(i, tnew[i]["attn"])
        for sid in sids:
            jpool.lens[sid] += 1
            tpool.lens[sid] += 1
        nxt = list(np.argmax(to_numpy(want)[:, -1], axis=-1))
    for layer in range(cfg.n_layers):
        np.testing.assert_array_equal(tpool.k_pages[layer].numpy(),
                                      np.asarray(jpool.k_pages[layer]))
        np.testing.assert_array_equal(tpool.v_scale[layer].numpy(),
                                      np.asarray(jpool.v_scale[layer]))

"""qwen2-0.5b in w4a8 and w4a4: the port's PTQ, forward logits and
continuous-batching engine against the reference, with the reference's own
weights carried across (reduced config, CPU).

Tolerances:
* packed int4 payloads and scales of every quantized weight: bit-exact.
* forward logits against the eager reference (the reference engine runs
  ``forward`` eagerly; see test_torch_transformer.py): 1% of max |logit|,
  as for W8A8. The int4 activation grid is 18× coarser than int8's, but
  both sides run the same integer chain on the same bf16 inputs.
* engine greedy streams and page accounting: identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import quantize_params as jax_quantize_params  # noqa: E402
from repro.serving.engine import \
    ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.models import forward, quantize_params  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402
from torch_parity import (check_streams, jax_to_numpy,  # noqa: E402
                          random_prompts, reduced_qwen_pair, to_numpy)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

INT4_MODES = ["w4a8", "w4a4"]


@pytest.fixture(scope="module")
def models():
    jcfg, jp, cfg, _ = reduced_qwen_pair()
    out = {}
    for qmode in INT4_MODES:
        jq = jax_quantize_params(jp, jcfg, qmode)
        out[qmode] = (jcfg.__class__(**{**jcfg.__dict__, "qmode": qmode}),
                      jq, cfg.__class__(**{**cfg.__dict__, "qmode": qmode}),
                      from_jax_params(jax_to_numpy(jq), device="cpu"), jp)
    return out


@pytest.mark.parametrize("qmode", INT4_MODES)
def test_quantize_params_int4_matches_reference(models, qmode):
    """The port's own PTQ of the reference's float weights gives the
    reference's packed payloads and scales, leaf for leaf."""
    jcfg, jq, cfg, tq, jp = models[qmode]
    got = quantize_params(from_jax_params(jax_to_numpy(jp), device="cpu"),
                          cfg, qmode)
    n_quantized = 0
    for lj, lt in zip(jq["layers"], got["layers"]):
        for part in ("attn", "mlp"):
            for key, jw in lj[part].items():
                tw = lt[part][key]
                if isinstance(jw, jquant.QuantizedTensor):
                    assert (tw.bits, tw.shape) == (4, tuple(jw.shape)), key
                    np.testing.assert_array_equal(tw.q.numpy(),
                                                  np.asarray(jw.q))
                    np.testing.assert_array_equal(tw.scale.numpy(),
                                                  np.asarray(jw.scale))
                    n_quantized += 1
                else:
                    assert not isinstance(tw, quant.QuantizedTensor), key
    assert n_quantized == 7 * cfg.n_layers


@pytest.mark.parametrize("qmode", INT4_MODES)
def test_forward_logits_match_eager_reference(models, qmode):
    jcfg, jq, cfg, tq, _ = models[qmode]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 24))
    want, _, _ = jax_forward(jq, jcfg, jnp.asarray(toks))
    got, _, _ = forward(tq, cfg, torch.from_numpy(toks))
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape
    err, tol = np.abs(got - want).max(), 1e-2 * np.abs(want).max()
    assert err <= tol, f"{qmode}: max |Δlogit| {err} > {tol}"


@pytest.mark.parametrize("qmode", INT4_MODES)
def test_engine_mixed_trace_matches_reference(models, qmode):
    """The mixed trace of test_torch_serving.py: requests entering and
    leaving over a pool too small for all of them at once."""
    jcfg, jq, cfg, tq, _ = models[qmode]
    specs = [(5, 6), (12, 4), (8, 10), (3, 3), (16, 5)]
    prompts = random_prompts([n for n, _ in specs], seed=10)
    kw = dict(kv_dtype="int8", page_size=8, capacity_tokens=64,
              prefill_chunk=8)
    jeng = JaxEngine(jq, jcfg, **kw)
    teng = ContinuousBatchingEngine(tq, cfg, device="cpu", **kw)
    for p, (_, mx) in zip(prompts, specs):
        jeng.submit(jnp.asarray(p), mx)
        teng.submit(torch.from_numpy(p), mx)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want)
    check_streams([got[s] for s in sorted(got)],
                  [want[s] for s in sorted(want)], jcfg, jq, prompts)
    assert teng.pool.num_free == teng.pool.num_pages
    assert teng.pool.free == jeng.pool.free

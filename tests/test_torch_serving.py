"""The port's continuous-batching engine against the reference's engine.

Cases of tests/test_serving.py, with the reference's own weights carried
across and ``page_size`` / ``prefill_chunk`` pinned in both engines
(prefix sharing is in test_torch_serving_prefix.py):

* the mixed trace (requests entering and leaving mid-flight over a pool
  too small for all of them at once) gives the reference's greedy streams,
  and each port stream equals the port's solo run;
* temperature sampling is deterministic and independent of co-scheduling;
* float pages (``kv_dtype=None``, the reference's default in ``generate``):
  the engine gives the reference's greedy streams and page accounting, and
  ``generate`` with no ``kv_dtype`` gives the reference's streams;
* reduced moonshot-v1-16b-a3b (an MoE FFN in every layer) in W8A8 over
  int8 pages: the reference's greedy streams and page accounting, drop-free
  and with a capacity factor that makes its prefill chunks drop tokens.

Greedy streams must be identical. A divergence would be acceptable only
where the reference's top-2 logit gap at the first differing step is
below the forward-logit tolerance (1% of max |logit|); the test reports
that gap if it ever happens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.models.moe as tmoe  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import quantize_params as jax_quantize_params  # noqa: E402
from repro.serving.engine import \
    ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro.serving.engine import generate as jax_generate  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serving.engine import (ContinuousBatchingEngine,  # noqa: E402
                                        generate)
from repro_torch.serving.spec_decode import SpecConfig  # noqa: E402
from torch_parity import (check_streams, jax_to_numpy,  # noqa: E402
                          random_prompts, reduced_qwen_pair)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def model():
    return reduced_qwen_pair()


@pytest.fixture(scope="module")
def moe_model():
    """Reduced moonshot-v1-16b-a3b in W8A8: (jax cfg, jax params, port
    cfg, port params)."""
    arch = "moonshot-v1-16b-a3b"
    jcfg = jax_get_config(arch, reduced=True, qmode="w8a8")
    jp = jax_quantize_params(jax_init_params(jax.random.PRNGKey(0), jcfg),
                             jcfg, "w8a8")
    return (jcfg, jp, get_config(arch, reduced=True, qmode="w8a8"),
            from_jax_params(jax_to_numpy(jp), device="cpu"))


def test_mixed_trace_matches_reference_and_solo(model):
    jcfg, jp, cfg, tp = model
    specs = [(5, 6), (12, 4), (8, 10), (3, 3), (16, 5)]     # (prompt, max_new)
    prompts = random_prompts([n for n, _ in specs], seed=10)
    kw = dict(kv_dtype="int8", page_size=8, capacity_tokens=64,
              prefill_chunk=8)
    jeng = JaxEngine(jp, jcfg, **kw)
    teng = ContinuousBatchingEngine(tp, cfg, device="cpu", **kw)
    for p, (_, mx) in zip(prompts, specs):
        jeng.submit(jnp.asarray(p), mx)
        teng.submit(torch.from_numpy(p), mx)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want)
    check_streams([got[s] for s in sorted(got)],
                   [want[s] for s in sorted(want)], jcfg, jp, prompts)
    assert teng.pool.num_free == teng.pool.num_pages
    assert teng.pool.free == jeng.pool.free
    for i, (p, (_, mx)) in enumerate(zip(prompts, specs)):
        solo = ContinuousBatchingEngine(tp, cfg, device="cpu", **kw)
        sid = solo.submit(torch.from_numpy(p), mx)
        assert solo.run()[sid] == got[i], f"request {i} diverged under batching"


def test_temperature_sampling_deterministic_and_batch_independent(model):
    _, _, cfg, tp = model
    prompts = random_prompts([8, 11, 5], seed=30)
    kw = dict(sample="temperature", temperature=0.8, seed=3, page_size=8,
              prefill_chunk=8, capacity_tokens=256, device="cpu")

    def run(ps):
        eng = ContinuousBatchingEngine(tp, cfg, **kw)
        sids = [eng.submit(torch.from_numpy(p), 6) for p in ps]
        out = eng.run()
        return [out[s] for s in sids]

    batched = run(prompts)
    assert batched == run(prompts)
    # the same request (same seq_id 1) beside a different neighbour
    eng = ContinuousBatchingEngine(tp, cfg, **kw)
    eng.submit(torch.from_numpy(prompts[2]), 6)
    sid = eng.submit(torch.from_numpy(prompts[1]), 6)
    assert eng.run()[sid] == batched[1]
    toks = generate(tp, cfg, torch.from_numpy(np.stack([prompts[0]] * 2)),
                    steps=4, sample="temperature", temperature=0.8,
                    device="cpu")
    assert toks.shape == (2, 4)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()


def test_engine_rejects_oversized_request_and_unported_options(model):
    _, _, cfg, tp = model
    eng = ContinuousBatchingEngine(tp, cfg, page_size=8, capacity_tokens=16,
                                   device="cpu")
    eng.submit(torch.zeros(8, dtype=torch.long), 32)  # 5 pages, pool has 2
    with pytest.raises(RuntimeError):
        eng.run()
    # speculative decoding is ported: a window below 1 is refused
    with pytest.raises(ValueError, match="gamma"):
        ContinuousBatchingEngine(tp, cfg, device="cpu",
                                 spec=SpecConfig(method="ngram", gamma=0))


def test_float_page_engine_matches_reference(model):
    """kv_dtype=None: bf16 pages, no scales, attention through the plain
    versions in both packages. Three prompts share a 16-token prefix, two
    more enter mid-flight; page accounting after every step and the greedy
    streams must be identical."""
    jcfg, jp, cfg, tp = model
    prefix = random_prompts([16], seed=50)[0]
    prompts = [np.concatenate([prefix, t])
               for t in random_prompts([4, 9, 6], seed=51)]
    prompts += random_prompts([7, 12], seed=52)
    kw = dict(kv_dtype=None, page_size=8, capacity_tokens=160,
              prefill_chunk=8)
    jeng = JaxEngine(jp, jcfg, **kw)
    teng = ContinuousBatchingEngine(tp, cfg, device="cpu", **kw)
    assert not teng.pool.quantized
    assert teng.pool.k_pages[0].dtype == torch.bfloat16
    for p in prompts:
        jeng.submit(jnp.asarray(p), 5)
        teng.submit(torch.from_numpy(p), 5)
    shared = 0
    while True:
        more = teng.step()
        assert jeng.step() == more
        assert teng.pool.shared_page_stats() == jeng.pool.shared_page_stats()
        assert teng.pool.tables == jeng.pool.tables
        shared = max(shared, teng.pool.shared_page_stats()["shared_slots"])
        if not more:
            break
    assert shared == 2                      # the 16-token prefix, 2 pages
    got = {s: r.tokens for s, r in teng.finished.items()}
    want = {s: r.tokens for s, r in jeng.finished.items()}
    assert sorted(got) == sorted(want)
    check_streams([got[s] for s in sorted(got)],
                  [want[s] for s in sorted(want)], jcfg, jp, prompts)
    assert teng.pool.free == jeng.pool.free


def test_generate_default_is_float_pages_like_reference(model):
    """``generate`` with no ``kv_dtype`` serves float pages in both
    packages and gives the same greedy streams."""
    jcfg, jp, cfg, tp = model
    prompts = random_prompts([12, 12], seed=53)
    batch = np.stack(prompts)
    want = jax_generate(jp, jcfg, jnp.asarray(batch), steps=6)
    got = generate(tp, cfg, torch.from_numpy(batch), steps=6, device="cpu")
    check_streams(got.tolist(), np.asarray(want).tolist(), jcfg, jp, prompts)


@pytest.mark.parametrize("capacity_factor", [None, 0.25],
                         ids=["drop-free", "prefill drops"])
def test_moe_engine_matches_reference(moe_model, monkeypatch,
                                      capacity_factor):
    """Two requests sharing a 16-token prefix, 8 new tokens each, in
    lockstep on both engines, chunks of 16 tokens: page tables, sharing
    and greedy streams identical after every step. Capacity factor 0.25
    leaves 8 slots an expert for a chunk's 32 top-2 picks, so prefill
    chunks drop tokens (counted through the port's ``_route``); a decode
    batch of at most 2 tokens never drops. (The reference compiles every
    eager op at each new shape: the first case takes about a minute.)"""
    jcfg, jp, cfg, tp = moe_model
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=capacity_factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=capacity_factor)
    dropped = {"prefill": 0, "decode": 0}
    inner = tmoe._route

    def counting(gates, k, cap):
        slots, weights = inner(gates, k, cap)
        lane = "decode" if gates.shape[1] <= 2 else "prefill"
        dropped[lane] += int((slots == gates.shape[-1] * cap).sum())
        return slots, weights
    monkeypatch.setattr(tmoe, "_route", counting)
    prefix = random_prompts([16], seed=60)[0]
    prompts = [np.concatenate([prefix, t])
               for t in random_prompts([16, 8], seed=61)]
    kw = dict(kv_dtype="int8", page_size=8, capacity_tokens=160,
              prefill_chunk=16)
    jeng = JaxEngine(jp, jcfg, **kw)
    teng = ContinuousBatchingEngine(tp, cfg, device="cpu", **kw)
    for p in prompts:
        jeng.submit(jnp.asarray(p), 8)
        teng.submit(torch.from_numpy(p), 8)
    while True:
        more = teng.step()
        assert jeng.step() == more
        assert teng.pool.tables == jeng.pool.tables
        assert teng.pool.shared_page_stats() == jeng.pool.shared_page_stats()
        if not more:
            break
    got = {s: r.tokens for s, r in teng.finished.items()}
    want = {s: r.tokens for s, r in jeng.finished.items()}
    assert sorted(got) == sorted(want) == [0, 1]
    check_streams([got[s] for s in sorted(got)],
                  [want[s] for s in sorted(want)], jcfg, jp, prompts)
    assert teng.pool.free == jeng.pool.free
    assert teng.pool.num_free == teng.pool.num_pages
    assert dropped["decode"] == 0
    assert (dropped["prefill"] > 0) == (capacity_factor is not None)

"""Prefix sharing in the port's engine against the reference's engine.

The prefix-sharing case of tests/test_serving.py, with the reference's own
weights carried across and ``page_size`` / ``prefill_chunk`` pinned in both
engines: the same page accounting after every admission step and the same
greedy streams. Then the reference benchmark's prefix workload: 8
sequences × a 64-token prefix hold 4 shared pages instead of 32.

Greedy streams must be identical. A divergence would be acceptable only
where the reference's top-2 logit gap at the first differing step is
below the forward-logit tolerance (1% of max |logit|); the test reports
that gap if it ever happens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving.engine import \
    ContinuousBatchingEngine as JaxEngine  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402
from torch_parity import (check_streams, random_prompts,  # noqa: E402
                          reduced_qwen_pair)
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def model():
    return reduced_qwen_pair()


def test_prefix_sharing_matches_reference(model):
    jcfg, jp, cfg, tp = model
    n, prefix_len, tail_len, ps = 4, 32, 8, 8
    prefix = random_prompts([prefix_len], seed=20)[0]
    prompts = [np.concatenate([prefix, t])
               for t in random_prompts([tail_len] * n, seed=21)]
    kw = dict(kv_dtype="int8", page_size=ps, capacity_tokens=8 * 64,
              prefill_chunk=16)
    jeng = JaxEngine(jp, jcfg, **kw)
    teng = ContinuousBatchingEngine(tp, cfg, device="cpu", **kw)
    for p in prompts:
        jeng.submit(jnp.asarray(p), 6)
        teng.submit(torch.from_numpy(p), 6)
    while teng.waiting or teng.prefilling:
        teng.step()
        jeng.step()
        assert teng.pool.shared_page_stats() == jeng.pool.shared_page_stats()
        assert teng.pool.tables == jeng.pool.tables
    stats = teng.pool.shared_page_stats()
    assert stats["shared_slots"] == prefix_len // ps
    assert stats["table_entries"] - stats["distinct_slots"] == \
        (n - 1) * prefix_len // ps
    got, want = teng.run(), jeng.run()
    check_streams([got[s] for s in sorted(got)],
                   [want[s] for s in sorted(want)], jcfg, jp, prompts)
    assert teng.pool.num_free == teng.pool.num_pages
    assert teng.pool.num_retained == jeng.pool.num_retained


def test_prefix_sharing_8x64_holds_4_pages_not_32(model):
    """The reference benchmark's prefix workload (page size 16)."""
    _, _, cfg, tp = model
    n, prefix_len, ps = 8, 64, 16
    prefix = random_prompts([prefix_len], seed=7)[0]
    eng = ContinuousBatchingEngine(tp, cfg, page_size=ps, prefill_chunk=128,
                                   capacity_tokens=n * 2 * (prefix_len + 26),
                                   device="cpu")
    for t in random_prompts([ps] * n, seed=8):
        eng.submit(torch.from_numpy(np.concatenate([prefix, t])), n + 2)
    while eng.waiting or eng.prefilling:
        eng.step()
    stats = eng.pool.shared_page_stats()
    assert stats["shared_slots"] == 4                     # not 8 × 4 = 32
    assert stats["table_entries"] - stats["distinct_slots"] == 28
    eng.run()
    assert eng.pool.num_free == eng.pool.num_pages

"""The reference benchmark's speculative workload on the port's engine.

``benchmarks/decode_serving.py``'s speculative section: its config (4
layers, d 256, vocab 8,192, bf16) with the reference's PRNGKey(0)
weights carried across, the prompt ``randint(PRNGKey(11), (8,))`` tiled
8×, n-gram drafting at γ 4, page 16, int8 pages, 48 new tokens. The port
must give ``BENCH_decode.json``'s verify steps, proposed and accepted
counts (18, 43, 29), and a stream equal to its own non-speculative one.

The file was written by a JAX whose threefry PRNG was not yet
"partitionable"; JAX 0.5 made that the default, which changes every
``jax.random`` draw. Under the current default the reference itself gives
30 steps, 49 proposed and 17 accepted for the same call (ROADMAP queue 3),
and the recorded counts come back with the old setting, so the inputs are
drawn under it here.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.serving.engine import ContinuousBatchingEngine  # noqa: E402
from repro_torch.serving.spec_decode import SpecConfig  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402
from torch_parity import one_thread  # noqa: E402,F401 (autouse)
from torch_parity import autotune_cache  # noqa: E402,F401 (autouse)

BENCH = json.loads((Path(__file__).resolve().parent.parent
                    / "BENCH_decode.json").read_text())["speculative"]
# benchmarks/decode_serving.py: _cfg(), PAGE_SIZE, SPEC_* (non-tiny)
BENCH_CFG = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                 head_dim=64, d_ff=1024, vocab_size=8192, max_seq_len=256)
PAGE_SIZE, PATTERN, REPEATS = 16, 8, 8


def test_benchmark_speculative_workload_gives_recorded_counts():
    jcfg = jax_get_config("qwen2-0.5b", **BENCH_CFG)
    with jax.threefry_partitionable(False):
        jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
        prompt = np.tile(np.asarray(jax.random.randint(
            jax.random.PRNGKey(11), (PATTERN,), 0, jcfg.vocab_size)),
            REPEATS)
    assert prompt.shape[0] == BENCH["prompt_tokens"]
    new = BENCH["new_tokens"]
    cfg = get_config("qwen2-0.5b", **BENCH_CFG)
    params = from_jax_params(jax_to_numpy(jp), device="cpu")
    keys = ("spec_steps", "proposed", "accepted")

    def run(spec):
        eng = ContinuousBatchingEngine(
            params, cfg, kv_dtype="int8", page_size=PAGE_SIZE,
            capacity_tokens=4 * (prompt.shape[0] + new), spec=spec,
            device="cpu")
        sid = eng.submit(torch.from_numpy(prompt), new)
        out = eng.run()[sid]
        assert eng.pool.num_free == eng.pool.num_pages
        eng.pool.check_invariants()
        return out, eng.spec_summary()

    base, _ = run(None)
    got, s = run(SpecConfig(method=BENCH["method"], gamma=BENCH["gamma"]))
    assert got == base
    assert BENCH["greedy_parity"]
    assert [s[k] for k in keys] == [BENCH[k] for k in keys] == [18, 43, 29]
    assert s["emitted"] == new - 1       # every token after the first

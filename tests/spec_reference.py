"""The reference's speculative-engine results, recorded for the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/spec_reference.py

runs every case of :data:`CASES` on the reference's engine
(``repro.serving.engine.ContinuousBatchingEngine``) and writes
``tests/spec_reference.json``: per case, the greedy streams, each
request's ``spec_summary()`` counts, the free pages of the target and
draft pools, and the target pool's ``shared_page_stats()`` after every
step. ``tests/test_torch_spec_decode.py`` holds the port's engine to that
file, on the same numpy prompts and the reference's own weights carried
across. The reference engine runs eagerly and compiles every new panel
width and ``q_start``: the eighteen runs take about five minutes on the
CPU, too long for the tier-1 suite. So the test runs the reference live
(:func:`reference_case`) only for :data:`LIVE_CASES`, holds the recording
to those live runs, reads the recording for the other cases, and checks
that the weights it converts are the ones recorded (a SHA-256 of their
bytes).

The inputs are those of ``tests/test_spec_decode.py`` (its tiny f32
config, page size 8), with numpy prompts; ``prefill_chunk`` is pinned to
16 in both engines.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np

JSON_PATH = Path(__file__).resolve().parent / "spec_reference.json"
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, max_seq_len=256, dtype="float32")
BAD_DRAFT = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                 head_dim=16, d_ff=64, vocab_size=256, max_seq_len=256,
                 dtype="float32")
PS, CHUNK, CAPACITY = 8, 16, 2048
QMODES = ("w8a8", "none")


def prompts_main():
    """A repetitive prompt (drafts land) and a random one (drafts miss)."""
    rng = np.random.default_rng(1)
    pat = rng.integers(0, 256, 6).astype(np.int32)
    return [np.tile(pat, 6), rng.integers(0, 256, 17).astype(np.int32)]


def prompts_prefix():
    """Three prompts sharing a two-page prefix, with tails of 4, 7, 10."""
    rng = np.random.default_rng(20)
    prefix = rng.integers(0, 256, 2 * PS).astype(np.int32)
    return [np.concatenate([prefix, rng.integers(0, 256, 4 + 3 * i)
                            .astype(np.int32)]) for i in range(3)]


# name → (spec: method, gamma, draft ('self' | 'bad' | None)), prompts,
# max_new values
CASES = {
    "ngram": (("ngram", 3, None), prompts_main, (14,)),
    "strong_draft": (("draft", 3, "self"), prompts_main, (14,)),
    "bad_draft": (("draft", 3, "bad"), prompts_main, (14,)),
    "prefix_mixed": (("ngram", 2, None), prompts_prefix, (8,)),
    "budget": (("ngram", 4, None), prompts_main, (1, 2, 3, 5)),
    "auto_gamma": (("draft", "auto", "self"), prompts_main, (48,)),
}
# the cases the port's test runs on the reference live, as (qmode, name,
# max_new)
LIVE_CASES = (("w8a8", "ngram", 14), ("w8a8", "strong_draft", 14))


def weight_digest(tree) -> str:
    """SHA-256 over a numpy params tree's leaves, in walk order."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, np.ndarray):
            h.update(np.ascontiguousarray(x).tobytes())
        else:
            h.update(repr(x).encode())
    walk(tree)
    return h.hexdigest()


def reference_models(qmode):
    """(target cfg, target params, bad-draft cfg, bad-draft params) of the
    reference, in ``qmode``: the target from PRNGKey(0), the bad draft
    from PRNGKey(7), as tests/test_spec_decode.py builds them."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params, quantize_params
    cfg = get_config("qwen2-0.5b", qmode=qmode, **TINY)
    dcfg = get_config("qwen2-0.5b", qmode=qmode, **BAD_DRAFT)
    params = init_params(jax.random.PRNGKey(0), cfg)
    dparams = init_params(jax.random.PRNGKey(7), dcfg)
    if qmode != "none":
        params = quantize_params(params, cfg, qmode)
        dparams = quantize_params(dparams, dcfg, qmode)
    return cfg, params, dcfg, dparams


def run_engine(make_engine, submit, prompts, max_new):
    """Submit every prompt, step to the end; → the case's record."""
    eng = make_engine()
    sids = [submit(eng, p, max_new) for p in prompts]
    shared = []
    while True:
        more = eng.step()
        shared.append(eng.pool.shared_page_stats())
        if not more:
            break
    s = eng.spec_summary()
    keys = ("spec_steps", "proposed", "accepted", "emitted")
    rec = dict(
        streams=[list(map(int, eng.finished[i].tokens)) for i in sids],
        per_request=[[s["per_request"][i][k] for k in keys] for i in sids],
        totals=[s[k] for k in keys], gamma=s["gamma"],
        free=eng.pool.num_free, num_pages=eng.pool.num_pages,
        shared=shared)
    if getattr(eng.drafter, "pool", None) is not None:
        rec["draft_free"] = eng.drafter.pool.num_free
        rec["draft_pages"] = eng.drafter.pool.num_pages
    return rec


def reference_case(models, name, max_new):
    """One case of :data:`CASES` on the reference's engine, with
    ``models`` from :func:`reference_models`; → its record."""
    import jax.numpy as jnp
    from repro.serving.engine import ContinuousBatchingEngine
    from repro.serving.spec_decode import SpecConfig
    cfg, params, dcfg, dparams = models
    (method, gamma, draft), prompts, _ = CASES[name]
    dc, dp = {"self": (cfg, params), "bad": (dcfg, dparams),
              None: (None, None)}[draft]
    spec = SpecConfig(method=method, gamma=gamma, draft_cfg=dc,
                      draft_params=dp)
    return run_engine(
        lambda: ContinuousBatchingEngine(
            params, cfg, kv_dtype="int8", page_size=PS,
            capacity_tokens=CAPACITY, prefill_chunk=CHUNK, spec=spec),
        lambda eng, p, n: eng.submit(jnp.asarray(p), n), prompts(), max_new)


def main() -> int:
    from repro.core import autotune
    from torch_parity import jax_to_numpy

    os.environ["REPRO_AUTOTUNE_CACHE"] = str(JSON_PATH.with_suffix(".tmp"))
    out = {"digests": {}, "cases": {}}
    for qmode in QMODES:
        cfg, params, dcfg, dparams = reference_models(qmode)
        out["digests"][qmode] = [weight_digest(jax_to_numpy(params)),
                                 weight_digest(jax_to_numpy(dparams))]
        for name, (_, _, max_news) in CASES.items():
            for max_new in max_news:
                autotune.clear_cache(disk=True)
                rec = reference_case((cfg, params, dcfg, dparams), name,
                                     max_new)
                out["cases"][f"{qmode}/{name}/{max_new}"] = rec
                print(qmode, name, max_new, rec["totals"], rec["gamma"],
                      flush=True)
    autotune.clear_cache(disk=True)
    JSON_PATH.write_text(json.dumps(out, indent=None) + "\n")
    print(f"wrote {JSON_PATH}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    raise SystemExit(main())

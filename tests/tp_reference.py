"""The reference's replicated serving runs, recorded for the port's TP tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/tp_reference.py

runs the replicated side of ``tests/tp_parity_check.py``'s checks on the
reference (``repro``), at its configuration (qwen2-0.5b, 2 layers, d 64,
8/4 heads of 16, d_ff 128, vocab 512, f32, page 8, chunk 16), and writes
``tests/tp_reference.json``: the chunked prefill's and the four decode
steps' logits over a replicated pool; and per engine case (ENGINE: the
prefix-sharing mix; INDIV: d 60, 6/3 heads; QUANT: w8a8; SPEC: n-gram
gamma 3 and its plain twin) the greedy streams, the page accounting at a
mid-flight step and at the end, and ``spec_summary()``. Under ``moe``, per
MoE case (:data:`MOE_ARCHS` reduced × :data:`MOE_QMODES`: qmode none in
f32, w8a8 in the config's bf16): the replicated engine's greedy streams
and accounting on :func:`moe_prompts`, the first prompt's first-step
logits (its chunked paged prefill's last row) and the weights' SHA-256.
``tests/test_torch_tp_moe.py`` holds the port's MoE serving mesh to them.
``tests/test_torch_tp_serving.py`` holds four gloo ranks of the port to
that file, on the same numpy prompts and the reference's own weights
carried across. The reference engine runs eagerly and compiles every new
shape: the engine cases take about a minute on the CPU, more under the
suite's workers. So the test reruns only the prefill and decode live
(:func:`prefill_decode`) and holds the recording to them, reads the
recording for the engine cases, and checks that the weights it converts
are the ones recorded (a SHA-256 of their bytes).
"""
from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

JSON_PATH = Path(__file__).resolve().parent / "tp_reference.json"
PS, CHUNK, STEPS, TP = 8, 16, 4, 4
SMALL = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, head_dim=16,
             d_ff=128, vocab_size=512, max_seq_len=128)
INDIV = dict(SMALL, d_model=60, n_heads=6, n_kv_heads=3)
# the engine cases: name → (model, new tokens a request, mid-flight step,
# spec gamma or None)
CASES = {"engine": ("small", 6, 4, None), "indiv": ("indiv", 6, 2, None),
         "quant": ("quant", 6, None, None), "spec": ("small", 10, None, 3),
         "spec_base": ("small", 10, None, None)}
# the MoE engine cases: the reduced configs, (qmode, dtype override); new
# tokens a request and the mid-flight step
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-maverick-400b-a17b")
MOE_QMODES = (("none", "float32"), ("w8a8", None))
MOE_NEW, MOE_SNAP = 6, 3


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


def models():
    """name → (jax cfg, jax params, overrides of the port's get_config):
    the parity config in f32, INDIV's heads, and w8a8 at the config's own
    dtype, as ``tests/tp_parity_check.py`` builds them."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params, quantize_params
    out = {}
    for name, over in (("small", dict(SMALL, dtype="float32")),
                       ("indiv", dict(INDIV, dtype="float32")),
                       ("quant", dict(SMALL, qmode="w8a8"))):
        cfg = get_config("qwen2-0.5b", **over)
        params = init_params(jax.random.PRNGKey(0), cfg)
        if cfg.qmode != "none":
            params = quantize_params(params, cfg, cfg.qmode)
        out[name] = (cfg, params, over)
    return out


def moe_overrides(qmode, dtype) -> dict:
    """``get_config`` keywords of one MoE case (either package's)."""
    return dict(reduced=True, qmode=qmode,
                **({} if dtype is None else {"dtype": dtype}))


def moe_models():
    """"arch/qmode" → (jax cfg, jax params, ``get_config`` keywords) of
    every MoE case, the weights from PRNGKey(0)."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params, quantize_params
    out = {}
    for arch in MOE_ARCHS:
        for qmode, dtype in MOE_QMODES:
            over = moe_overrides(qmode, dtype)
            cfg = get_config(arch, **over)
            params = init_params(jax.random.PRNGKey(0), cfg)
            if qmode != "none":
                params = quantize_params(params, cfg, qmode)
            out[f"{arch}/{qmode}"] = (cfg, params, over)
    return out


def moe_prompts():
    """Three prompts of 11, 17 and 23 tokens (1, 2 and 2 chunks)."""
    import jax
    return [np.asarray(jax.random.randint(jax.random.PRNGKey(50 + i),
                                          (11 + 6 * i,), 0, 512))
            for i in range(3)]


def prompts():
    """The numpy prompts of every check, from the reference's keys."""
    import jax

    def rand(key, n, vocab=512):
        return np.asarray(jax.random.randint(key, (n,), 0, vocab))
    key = jax.random.PRNGKey(2)
    prefix = rand(key, 2 * PS)
    skey = jax.random.PRNGKey(4)
    pattern = rand(skey, 6)
    spec = [np.tile(pattern, 5), rand(jax.random.fold_in(skey, 1), 13)]
    return {"prefill": rand(jax.random.PRNGKey(1), 3 * CHUNK - 4),
            "engine": [np.concatenate([prefix, rand(jax.random.fold_in(
                key, i), 5 + 3 * i)]) for i in range(3)],
            "indiv": [rand(jax.random.PRNGKey(9 + i), 10 + 3 * i)
                      for i in range(2)],
            "quant": [rand(jax.random.PRNGKey(30 + i), 10 + 4 * i)
                      for i in range(2)],
            "spec": spec, "spec_base": spec}


def state(eng):
    """The replicated host-side accounting."""
    return {"tables": {k: [int(s) for s in v]
                       for k, v in eng.pool.tables.items()},
            "lens": {k: int(v) for k, v in eng.pool.lens.items()},
            "stats": eng.pool.shared_page_stats(), "free": eng.pool.num_free,
            "retained": eng.pool.num_retained}


def engine_case(cfg, params, prompt_list, new, snap_at, gamma):
    """One replicated engine run → streams, mid / end accounting, spec
    summary."""
    import jax.numpy as jnp
    from repro.serving.engine import ContinuousBatchingEngine
    from repro.serving.spec_decode import SpecConfig
    spec = None if gamma is None else SpecConfig(method="ngram", gamma=gamma)
    eng = ContinuousBatchingEngine(params, cfg, kv_dtype="int8",
                                   page_size=PS, capacity_tokens=512,
                                   spec=spec)
    sids = [eng.submit(jnp.asarray(p), new) for p in prompt_list]
    mid, steps = None, 0
    while eng.step():
        steps += 1
        if steps == snap_at:
            mid = state(eng)
    return {"tokens": [[int(t) for t in eng.finished[s].tokens]
                       for s in sids], "mid": mid, "end": state(eng),
            "spec": eng.spec_summary() if spec is not None else None}


def prefill_decode(cfg, params, prompt, steps=STEPS):
    """Chunked paged prefill and ``steps`` ragged decode steps over a
    replicated pool → (each chunk's last logits, each step's logits)."""
    import jax.numpy as jnp
    from repro.models.transformer import forward
    from repro.serving.kv_cache import PagePool
    pool = PagePool(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.hd, num_pages=64, page_size=PS,
                    quantized=True, dtype=jnp.float32)
    s = len(prompt)
    pool.reserve(0, s + steps)
    pre, pos = [], 0
    while pos < s:
        c = min(CHUNK, s - pos)
        caches = [{"attn": pool.prefill_cache(i, 0, pos, 2)}
                  for i in range(cfg.n_layers)]
        lg, new, _ = forward(params, cfg, jnp.asarray(prompt)[None,
                                                            pos:pos + c],
                             positions=(pos + jnp.arange(c))[None],
                             caches=caches, last_logits_only=True)
        for i, layer in enumerate(new):
            pool.writeback(i, layer["attn"])
        pool.lens[0] = pos + c
        pre.append(np.asarray(lg[:, -1], np.float32))
        pos += c
    tok = jnp.asarray(pre[-1].argmax(-1)[:, None], jnp.int32)
    dec = []
    for _ in range(steps):
        pool.ensure_writable(0, pool.lens[0] // PS)
        tables, lengths = pool.batch_tables([0])
        caches = [{"attn": pool.layer_cache(i, tables, lengths)}
                  for i in range(cfg.n_layers)]
        lg, new, _ = forward(params, cfg, tok, positions=lengths[:, None],
                             caches=caches)
        for i, layer in enumerate(new):
            pool.writeback(i, layer["attn"])
        pool.lens[0] += 1
        last = np.asarray(lg[:, -1], np.float32)
        dec.append(last)
        tok = jnp.asarray(last.argmax(-1)[:, None], jnp.int32)
    return pre, dec


def _int_keys(x):
    """JSON's string keys back to the ints of tables, lens and per-request
    summaries."""
    if isinstance(x, dict):
        return {(int(k) if isinstance(k, str) and k.isdigit() else k):
                _int_keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_int_keys(v) for v in x]
    return x


def load() -> dict:
    """The recording, with its logits as f32 arrays and its int keys."""
    rec = json.loads(JSON_PATH.read_text())
    for k in ("prefill", "decode"):
        rec[k] = [np.asarray(a, np.float32) for a in rec[k]]
    rec["cases"] = _int_keys(rec["cases"])
    rec["moe"] = _int_keys(rec["moe"])
    for case in rec["moe"].values():
        case["first"] = np.asarray(case["first"], np.float32)
    return rec


def main() -> int:
    import os
    from repro.core import autotune
    from torch_parity import jax_to_numpy

    os.environ["REPRO_AUTOTUNE_CACHE"] = str(JSON_PATH.with_suffix(".tmp"))
    autotune.clear_cache(disk=True)
    ms, ps = models(), prompts()
    cfg, params, _ = ms["small"]
    pre, dec = prefill_decode(cfg, params, ps["prefill"])
    out = {"digests": {n: weight_digest(jax_to_numpy(p))
                       for n, (_, p, _) in ms.items()},
           "prefill": [a.tolist() for a in pre],
           "decode": [a.tolist() for a in dec], "cases": {}}
    for name, (model, new, snap_at, gamma) in CASES.items():
        cfg, params, _ = ms[model]
        out["cases"][name] = engine_case(cfg, params, ps[name], new,
                                         snap_at, gamma)
        print(name, out["cases"][name]["tokens"], flush=True)
    out["moe"] = {}
    for name, (cfg, params, _) in moe_models().items():
        case = engine_case(cfg, params, moe_prompts(), MOE_NEW, MOE_SNAP,
                           None)
        pre, _ = prefill_decode(cfg, params, moe_prompts()[0], steps=0)
        case["first"] = pre[-1][0].tolist()
        case["digest"] = weight_digest(jax_to_numpy(params))
        out["moe"][name] = case
        print(name, case["tokens"], flush=True)
    autotune.clear_cache(disk=True)
    JSON_PATH.write_text(json.dumps(out, indent=None) + "\n")
    print(f"wrote {JSON_PATH}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    raise SystemExit(main())

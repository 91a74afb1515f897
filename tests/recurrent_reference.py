"""The reference's dense-slab greedy streams of the recurrent and frontend
configs, recorded for the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/recurrent_reference.py

runs ``repro.serving.engine.generate`` (which sends these models to its
dense-slab loop) for every case of :data:`ARCHS` × :data:`CASES` on the
reduced configs (the float mode in f32, the integer modes in bf16: see
:data:`CASES`), with the reference's weights from PRNGKey(0), and writes
``tests/recurrent_reference.json``: per case, the greedy streams and a
SHA-256 of the weights (as the numpy tree the port converts).
``tests/test_torch_recurrent_serving.py`` holds the port's ``generate`` to
that file, on the same numpy prompts and the reference's own weights
carried across. The eager reference compiles every op at each new shape:
the reduced jamba alone takes about 20 s a mode on the CPU, too long for
the tier-1 suite in every mode. So the test runs the reference live
(:func:`reference_streams`) only for :data:`LIVE_CASES`, one a model, holds
the recording to those live runs, reads the recording for the other
cases, and checks that the weights it converts are the ones recorded.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from spec_reference import weight_digest  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402

JSON_PATH = Path(__file__).resolve().parent / "recurrent_reference.json"
ARCHS = ("jamba-v0.1-52b", "rwkv6-7b", "pixtral-12b", "musicgen-large")
# (qmode, dtype): the float mode in f32, the integer modes in the models'
# bf16. In bf16 the float mode's einsums (MoE experts, attention) round an
# f32 sum of another order now and then, and the reduced jamba's eight
# layers amplify one such flip (in layer 3's expert einsum) to 1.15% of
# max |logit| two decode steps on, where its none stream flips a near-tie
# (0.0059 apart) at its last step; in f32 the port stays within 1e-5 of
# the reference there. The integer modes are bit for bit in bf16 here,
# and chaotic in f32 (a last-bit difference flips an int8 rounding).
CASES = (("none", "float32"), ("w8a8", "bfloat16"), ("w4a8", "bfloat16"),
         ("w4a4", "bfloat16"))
BATCH, PROMPT_LEN, STEPS = 2, 12, 6
# one case a model runs on the reference live in the test
LIVE_CASES = (("jamba-v0.1-52b", "w8a8"), ("rwkv6-7b", "w4a4"),
              ("pixtral-12b", "none"), ("musicgen-large", "w4a8"))


def prompt(cfg, seed=5):
    """The batch's prompt as numpy: token ids (B, S) int32, or embeddings
    (B, S, D) f32 (bf16-representable) for a model with
    ``embedding_inputs``."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        import ml_dtypes
        x = rng.standard_normal((BATCH, PROMPT_LEN, cfg.d_model))
        return x.astype(ml_dtypes.bfloat16).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN)
                        ).astype(np.int32)


def config(arch, qmode, dtype, get_config):
    """The reduced ``arch`` in ``qmode`` and ``dtype``, from either
    package's ``get_config``."""
    return get_config(arch, reduced=True, qmode=qmode, dtype=dtype)


def reference_models(arch):
    """{qmode: (reference cfg, params)} of the reduced ``arch``, one per
    case of :data:`CASES`."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params, quantize_params
    out, drawn = {}, {}
    for qmode, dtype in CASES:
        cfg = config(arch, qmode, dtype, get_config)
        if dtype not in drawn:
            drawn[dtype] = init_params(jax.random.PRNGKey(0), cfg)
        out[qmode] = (cfg, quantize_params(drawn[dtype], cfg, qmode))
    return out


def reference_streams(cfg, params):
    """The reference's ``generate`` on :func:`prompt`: a list of streams."""
    import jax.numpy as jnp
    from repro.serving.engine import generate
    x = jnp.asarray(prompt(cfg), jnp.bfloat16 if cfg.embedding_inputs
                    else jnp.int32)
    return np.asarray(generate(params, cfg, x, steps=STEPS)).tolist()


def main() -> int:
    cases = {}
    for arch in ARCHS:
        for qmode, (cfg, params) in reference_models(arch).items():
            cases[f"{arch}/{qmode}"] = dict(
                dtype=cfg.dtype, streams=reference_streams(cfg, params),
                weights_sha256=weight_digest(jax_to_numpy(params)))
            print(arch, qmode, cases[f"{arch}/{qmode}"]["streams"][0])
    JSON_PATH.write_text(json.dumps(dict(
        batch=BATCH, prompt_len=PROMPT_LEN, steps=STEPS, cases=cases),
        indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The reference's training numbers on the reduced configs, recorded for
the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/train_reference.py

writes ``tests/train_reference.json`` (~1 min):

* ``grads``: for each model of :data:`GRAD_ARCHS` in f32, with the
  reference's weights from PRNGKey(0) and the batch of :func:`grad_batch`,
  the jitted ``loss_fn`` and, per gradient leaf (keyed by its tree path),
  its L2 norm, max |g| and its values at :data:`SAMPLES` fixed flat
  indices (the leaf's argmax among them): full gradient trees would be
  megabytes;
* ``loops``: ``repro.train.loop.run`` over :data:`LOOP_STEPS` steps of
  the reduced qwen3-0.6b on ``SyntheticLMData(vocab, 8, 32, seed=0)``
  from the reference's ``init_train_state``, for each case of
  :data:`LOOP_CASES`: the loss of every step;

each with a SHA-256 of the weights (or the whole initial state) as the
numpy tree the port converts. The eager and jitted reference compile for
several seconds a model (the reduced jamba ~13 s), so
``tests/test_torch_train.py`` runs the reference live only for
:data:`LIVE_ARCH`, holds the recording to that live run, and reads the
rest from the file after checking the digests.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from spec_reference import weight_digest  # noqa: E402
from torch_parity import jax_to_numpy  # noqa: E402

JSON_PATH = Path(__file__).resolve().parent / "train_reference.json"
GRAD_ARCHS = ("qwen3-0.6b", "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
              "rwkv6-7b", "pixtral-12b")
LIVE_ARCH = "qwen3-0.6b"
GRAD_B, GRAD_S = 2, 32
SAMPLES = 32
LOOP_STEPS = 30
# (name, dtype, quantize_moments, compress_grads)
LOOP_CASES = (("f32", "float32", False, None),
              ("f32 int8", "float32", True, "int8"),
              ("bf16", "bfloat16", False, None))
LOOP_LR = 3e-3


def grad_config(arch, get_config):
    """The reduced ``arch`` in f32, from either package's ``get_config``."""
    return get_config(arch, reduced=True, dtype="float32")


def grad_batch(cfg) -> dict:
    """The gradient cases' batch as numpy: token ids (B, S) int32, or
    embeddings (B, S, D) f32 for a model with ``embedding_inputs``; labels
    (B, S) int32."""
    rng = np.random.default_rng(1)
    if cfg.embedding_inputs:
        inputs = rng.standard_normal((GRAD_B, GRAD_S, cfg.d_model)
                                     ).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (GRAD_B, GRAD_S)
                              ).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (GRAD_B, GRAD_S)
                          ).astype(np.int32)
    return {"inputs": inputs, "labels": labels}


def sample_indices(size: int, leaf_no: int, flat: np.ndarray) -> list:
    """:data:`SAMPLES` fixed flat indices of a leaf (all of a smaller
    one), with the leaf's argmax |g| among them."""
    rng = np.random.default_rng(leaf_no)
    idx = set(rng.choice(size, min(size, SAMPLES), replace=False).tolist())
    idx.add(int(np.abs(flat).argmax()))
    return sorted(idx)


def summarize(grads: list) -> dict:
    """[(path key, f32 numpy gradient)] → {key: {norm, max, idx, val}}."""
    out = {}
    for no, (key, g) in enumerate(grads):
        flat = g.reshape(-1).astype(np.float64)
        idx = sample_indices(flat.size, no, flat)
        out[key] = dict(norm=float(np.sqrt((flat ** 2).sum())),
                        max=float(np.abs(flat).max()), idx=idx,
                        val=[float(flat[i]) for i in idx])
    return out


def reference_grads(arch):
    """(params, weights digest, loss, [(path key, gradient)]) of the
    jitted reference's ``value_and_grad(loss_fn)`` on :func:`grad_batch`."""
    import jax
    from repro.configs import get_config
    from repro.models import init_params, loss_fn
    cfg = grad_config(arch, get_config)
    params = init_params(jax.random.PRNGKey(0), cfg)
    batch = grad_batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, cfg, batch)))(params)
    flat = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), np.asarray(g, np.float32))
            for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]]
    return (params, weight_digest(jax_to_numpy(params)), float(loss),
            flat)


def loop_setup(case, get_config, adamw, build_train_step):
    """(cfg, optimizer, train_step) of a :data:`LOOP_CASES` entry, from
    either package."""
    _, dtype, qm, cg = case
    cfg = get_config("qwen3-0.6b", reduced=True, dtype=dtype)
    opt = adamw(lr=LOOP_LR, quantize_moments=qm)
    return cfg, opt, build_train_step(cfg, opt, compress_grads=cg)


def reference_loop(case):
    """(initial state digest, losses) of the reference's loop."""
    import jax
    from repro.configs import get_config
    from repro.data import SyntheticLMData
    from repro.optim import adamw
    from repro.train import build_train_step, init_train_state
    from repro.train import loop
    cfg, opt, step = loop_setup(case, get_config, adamw, build_train_step)
    state = init_train_state(jax.random.PRNGKey(0), cfg, opt)
    digest = weight_digest(jax_to_numpy(state))
    _, hist = loop.run(step, state, SyntheticLMData(cfg.vocab_size, 8, 32,
                                                    seed=0),
                       steps=LOOP_STEPS, log_every=0)
    return digest, hist["loss"]


def main() -> int:
    grads = {}
    for arch in GRAD_ARCHS:
        _, digest, loss, flat = reference_grads(arch)
        grads[arch] = dict(weights_sha256=digest, loss=loss,
                           leaves=summarize(flat))
        print(arch, loss)
    loops = {}
    for case in LOOP_CASES:
        digest, losses = reference_loop(case)
        loops[case[0]] = dict(state_sha256=digest, loss=losses)
        print(case[0], losses[0], losses[-1])
    JSON_PATH.write_text(json.dumps(dict(
        grad_batch=[GRAD_B, GRAD_S], samples=SAMPLES, loop_steps=LOOP_STEPS,
        grads=grads, loops=loops), separators=(",", ":")) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The port's config registry equals the reference's, field by field."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import reduce_config as jax_reduce  # noqa: E402
from repro_torch.configs import REGISTRY, get_config, reduce_config  # noqa: E402


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_registry_names_match():
    assert list(REGISTRY) == list(JAX_REGISTRY)


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_config_and_reduced_config_match(name):
    assert _fields(REGISTRY[name]) == _fields(JAX_REGISTRY[name])
    assert _fields(reduce_config(REGISTRY[name])) == \
        _fields(jax_reduce(JAX_REGISTRY[name]))
    # derived properties and counts follow the same formulas
    ours, ref = REGISTRY[name], JAX_REGISTRY[name]
    assert (ours.hd, ours.param_count(), ours.active_param_count()) == \
        (ref.hd, ref.param_count(), ref.active_param_count())


def test_get_config_overrides():
    cfg = get_config("qwen2-0.5b", reduced=True, qmode="w8a8")
    assert cfg.qmode == "w8a8" and cfg.name == "qwen2-0.5b-smoke"
    with pytest.raises(KeyError):
        get_config("no-such-arch")

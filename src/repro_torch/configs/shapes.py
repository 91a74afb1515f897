"""Assigned input shapes (LM-family: seq_len × global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``. ``long_500k`` requires
sub-quadratic attention: it runs only for ssm/hybrid families (rwkv6-7b,
jamba-v0.1-52b) and is recorded SKIP(sub-quadratic) for pure-attention archs
(see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'
    subquadratic_only: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode",
                           subquadratic_only=True),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def runnable(arch_family: str, shape: ShapeSpec) -> bool:
    if shape.subquadratic_only:
        return arch_family in SUBQUADRATIC_FAMILIES
    return True

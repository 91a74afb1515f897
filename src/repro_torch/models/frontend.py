"""Modality-frontend stand-ins (backbone only, as in the reference).

Port of ``repro/models/frontend.py``. pixtral-12b's ViT patch encoder and
musicgen-large's EnCodec tokenizer are not part of the backbone; those
models consume precomputed (B, S, d_model) patch or frame embeddings.
These helpers draw synthetic ones from a ``torch.Generator`` (on its own
device) for tests, the serve command and the smoke run.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def _normal(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int):
    return torch.randn((batch, seq, cfg.d_model), generator=gen,
                       device=gen.device).to(torch.bfloat16)


def synth_patch_embeddings(gen: torch.Generator, cfg: ModelConfig,
                           batch: int, seq: int) -> torch.Tensor:
    """Stand-in for a ViT patch encoder output (pixtral)."""
    return _normal(gen, cfg, batch, seq)


def synth_frame_embeddings(gen: torch.Generator, cfg: ModelConfig,
                           batch: int, seq: int) -> torch.Tensor:
    """Stand-in for EnCodec frame embeddings (musicgen)."""
    return _normal(gen, cfg, batch, seq)


def input_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.embedding_inputs else torch.int32


def input_shape(cfg: ModelConfig, batch: int, seq: int) -> tuple:
    if cfg.embedding_inputs:
        return (batch, seq, cfg.d_model)
    return (batch, seq)

"""Device choice for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU; with
no card and no explicit request they raise, so a run never falls back to
the CPU without saying so.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)

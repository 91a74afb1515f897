"""Decoder LM for the port: config, modules, attention, transformer."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (forward, init_caches,
                                            init_params,
                                            init_quantized_params, loss_fn,
                                            quantize_params)

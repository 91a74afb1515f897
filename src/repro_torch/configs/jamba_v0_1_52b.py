"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave (attention at
position 4 of every 8-layer block), MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]. Sub-quadratic → runs the long_500k cell."""
from repro_torch.models.config import ModelConfig

_PERIOD8 = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=65536,
    mixer_pattern=_PERIOD8,
    moe_experts=16, moe_top_k=2, moe_d_ff=14336, moe_period=2,
    ssm_expand=2, ssm_state_dim=16, ssm_conv_dim=4,
)

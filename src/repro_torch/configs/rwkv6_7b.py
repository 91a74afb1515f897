"""rwkv6-7b [ssm] — RWKV6 "Finch": attention-free, data-dependent decay.
[arXiv:2404.05892; hf]. Sub-quadratic → runs the long_500k cell (O(1) decode
state)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=14336, vocab_size=65536,
    mixer_pattern=("rwkv",), rwkv_head_dim=64, rwkv_chunk=32, rwkv_lora_r=64,
)

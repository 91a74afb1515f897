"""moonshot-v1-16b-a3b [moe] — Moonlight-16B-A3B: 64 experts, top-6,
per-expert d_ff=1408, MHA-16. [hf:moonshotai/Moonlight-16B-A3B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840,
    moe_experts=64, moe_top_k=6, moe_d_ff=1408, moe_period=1,
)

"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, interleaved MoE
(every other layer; gives the 400B-total / 17B-active budget), GQA kv=8,
early-fusion multimodal (frontend out of assigned scope).
[hf:meta-llama/Llama-4-Maverick; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    moe_experts=128, moe_top_k=1, moe_d_ff=8192, moe_period=2,
    rope_theta=5e5,
)

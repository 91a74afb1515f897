"""pixtral-12b [vlm] — Pixtral ViT frontend (STUB) + Mistral-NeMo-style decoder.
[hf:mistralai/Pixtral-12B-2409; unverified]. Backbone only per assignment;
input_specs provides precomputed patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e9, embedding_inputs=True,
)

"""musicgen-large [audio] — decoder-only over EnCodec tokens (frontend STUB).
[arXiv:2306.05284; hf]. input_specs provides precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    embedding_inputs=True,
)

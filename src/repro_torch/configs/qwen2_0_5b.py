"""qwen2-0.5b [dense] — GQA kv=2, QKV bias, tied embeddings.
[arXiv:2407.10671; hf]. NOTE: 14 heads do NOT divide the model=16 mesh axis —
the sharding rules degrade attention activations to replicated (weights still
shard on the flattened 896-wide qkv dim); d_ff=4864 shards 16-way fine."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)

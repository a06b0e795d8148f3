"""qwen1.5-0.5b [dense]: 24L d=1024 16H MHA(kv=16) d_ff=2816 v=151936,
QKV bias, tied embeddings [hf:Qwen/Qwen1.5-0.5B]."""

from ..models.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    remat="none",
)

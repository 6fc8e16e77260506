"""qwen2-1.5b — dense GQA, QKV bias [arXiv:2407.10671; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-1.5b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    head_dim=128, d_ff=8960, vocab=151936,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    source="arXiv:2407.10671",
))

"""qwen2.5-32b — dense GQA, QKV bias [hf:Qwen/Qwen2.5-32B family; hf]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    head_dim=128, d_ff=27648, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-32B",
))

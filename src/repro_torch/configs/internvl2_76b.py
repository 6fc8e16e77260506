"""internvl2-76b — InternViT frontend (stub) + InternLM2-76B backbone
[arXiv:2404.16821; unverified]. Backbone only per assignment; the vision
frontend is a stub providing precomputed patch embeddings."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=28672, vocab=128256,
    embed_stub=True, rope_theta=1e6,
    source="arXiv:2404.16821",
))

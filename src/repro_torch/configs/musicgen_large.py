"""musicgen-large — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf]. Audio frontend is a stub (precomputed frame
embeddings); backbone is the 48L/2048d decoder."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    head_dim=64, d_ff=8192, vocab=2048,
    embed_stub=True,
    source="arXiv:2306.05284",
))

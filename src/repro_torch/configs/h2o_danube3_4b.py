"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified]."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    head_dim=120, d_ff=10240, vocab=32000,
    swa_window=4096, rope_theta=1e4,
    source="arXiv:2401.16818",
))

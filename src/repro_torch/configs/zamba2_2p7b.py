"""zamba2-2.7b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf]."""
from .base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    head_dim=80, d_ff=10240, vocab=32000,
    ssm=SSMCfg(state_dim=64, head_dim=64, expand=2, conv_dim=4, chunk=256),
    attn_every=6,
    source="arXiv:2411.15242",
))

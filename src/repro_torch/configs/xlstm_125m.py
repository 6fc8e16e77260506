"""xlstm-125m — alternating sLSTM + mLSTM blocks [arXiv:2405.04517].
d_ff=0: the xLSTM blocks carry their own up/down projections."""
from .base import ArchConfig, XLSTMCfg, register

CONFIG = register(ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    head_dim=192, d_ff=0, vocab=50304,
    xlstm=XLSTMCfg(),
    source="arXiv:2405.04517",
))

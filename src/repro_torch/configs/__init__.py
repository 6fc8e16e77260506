from .base import (SHAPES, ArchConfig, MoECfg, SSMCfg, ShapeConfig, XLSTMCfg,
                   all_archs, get_arch, load_all, register)

from .base import (ASSIGNED, SHAPES, ArchConfig, MoECfg, SSMCfg, ShapeConfig,
                   XLSTMCfg, all_archs, get_arch, load_all, register)

from .base import (ArchConfig, MoECfg, SSMCfg, XLSTMCfg, all_archs, get_arch,
                   load_all, register)

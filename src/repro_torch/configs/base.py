"""Architecture configs (the port's own copy of ``repro.configs.base``).

Every architecture gets a ``configs/<id>.py`` exporting CONFIG with the
published numbers.  ``reduced()`` derives the CPU-test variant (same
family, tiny sizes).  ``ShapeConfig`` / ``SHAPES`` name the solver's
cells (sequence length, global batch, kind), and ``param_count`` is
repro's approximate count.  The port runs every family of repro: the
dense, MoE, hybrid (zamba2) and SSM (xLSTM, pure Mamba2) families, and
the embedding-stub backbones (``embed_stub``: the VLM and audio configs,
whose frontends hand the decoder precomputed embeddings)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_dim: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMCfg:
    proj_factor_slstm: float = 4.0 / 3.0
    proj_factor_mlstm: float = 2.0
    conv_dim: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    qkv_bias: bool = False
    swa_window: Optional[int] = None
    rope_theta: float = 1e4
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    attn_every: int = 0
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    embed_stub: bool = False
    remat: bool = True
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    def param_count(self) -> float:
        """Approximate total parameter count (repro's rule)."""
        d, V = self.d_model, self.vocab
        n = V * d * (1 if self.tie_embeddings else 2)
        n += self._layer_params()
        return n

    def _layer_params(self) -> float:
        d, L = self.d_model, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        if self.xlstm is not None:
            x = self.xlstm
            per_s = 3 * d * d * x.proj_factor_slstm + d * d  # rough sLSTM
            per_m = 3 * d * d * x.proj_factor_mlstm + d * d  # rough mLSTM
            return L / 2 * (per_s + per_m)
        if self.family in ("ssm", "hybrid") and self.ssm is not None:
            di = self.d_inner
            per_ssm = d * (2 * di) + di * d + di * 2 * self.ssm.state_dim
            n = L * per_ssm
            if self.attn_every:
                # one shared block (applied L//attn_every times, params once)
                n += attn + 3 * d * self.d_ff
            return n
        if self.moe is not None:
            e = self.moe
            per = attn + d * e.n_experts + e.n_experts * 3 * d * e.d_ff_expert
            return L * per
        return L * (attn + 3 * d * self.d_ff)

    def active_param_count(self) -> float:
        """Activated params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (KV * hd) + (H * hd) * d
        e = self.moe
        per = attn + d * e.n_experts + e.top_k * 3 * d * e.d_ff_expert
        return 2 * self.vocab * d + L * per

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (same rule as repro)."""
        def shrink_moe(m: Optional[MoECfg]) -> Optional[MoECfg]:
            if m is None:
                return None
            return MoECfg(n_experts=min(4, m.n_experts),
                          top_k=min(2, m.top_k), d_ff_expert=64,
                          capacity_factor=8.0)

        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            swa_window=16 if self.swa_window else None,
            moe=shrink_moe(self.moe),
            ssm=SSMCfg(state_dim=8, head_dim=8, expand=2, conv_dim=4,
                       chunk=8) if self.ssm else None,
            attn_every=2 if self.attn_every else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_archs() -> List[str]:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all() -> None:
    import importlib
    for mod in ("zamba2_2p7b", "qwen2_1p5b", "llama3p2_3b",
                "h2o_danube3_4b", "qwen2p5_32b", "moonshot_16b_a3b",
                "phi3p5_moe", "xlstm_125m", "musicgen_large",
                "internvl2_76b"):
        importlib.import_module(f"repro_torch.configs.{mod}")

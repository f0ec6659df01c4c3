"""Registry of assigned architectures (``--arch <id>``)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, cell_is_runnable

from repro_torch.configs.gemma3_27b import CONFIG as _gemma3
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.command_r_plus_104b import CONFIG as _command_r
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3
from repro_torch.configs.arctic_480b import CONFIG as _arctic

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        _gemma3, _starcoder2, _command_r, _yi, _zamba2,
        _paligemma, _falcon_mamba, _hubert, _qwen3, _arctic,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells():
    """All (arch, shape, runnable, reason) assignment cells (10 x 4)."""
    out = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            ok, why = cell_is_runnable(a, s)
            out.append((a, s, ok, why))
    return out

"""Architecture registry: ``--arch <id>`` resolution for all launchers."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import LMConfig, ShapeSuite, SHAPES, SHAPES_BY_NAME, \
    shape_applicable, reduced

from repro_torch.configs import yi_6b, deepseek_7b, phi3_medium_14b, stablelm_1_6b, \
    phi3_vision_4_2b, musicgen_large, xlstm_350m, phi35_moe_42b, \
    granite_moe_1b, zamba2_1_2b

_MODULES = (
    yi_6b, deepseek_7b, phi3_medium_14b, stablelm_1_6b, phi3_vision_4_2b,
    musicgen_large, xlstm_350m, phi35_moe_42b, granite_moe_1b, zamba2_1_2b,
)

ARCHS: Dict[str, LMConfig] = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}


def get_config(arch_id: str) -> LMConfig:
    if arch_id not in ARCHS:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_reduced_config(arch_id: str) -> LMConfig:
    return reduced(get_config(arch_id))


def list_archs() -> List[str]:
    return sorted(ARCHS)


def dryrun_cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells; skipped cells carry their reason."""
    cells = []
    for arch_id in list_archs():
        cfg = ARCHS[arch_id]
        for shape in SHAPES:
            ok, reason = shape_applicable(cfg, shape)
            if ok or include_skips:
                cells.append((cfg, shape, ok, reason))
    return cells


__all__ = ["ARCHS", "get_config", "get_reduced_config", "list_archs",
           "dryrun_cells", "SHAPES", "SHAPES_BY_NAME"]

"""Config registry: `get_config(arch_id)` and ARCHS listing (the
counterpart of `repro.configs`; `bilevel_mlp` holds the §6.2 MLP's
widths)."""
from .base import ArchConfig, InputShape, INPUT_SHAPES

from .granite_moe_3b_a800m import CONFIG as _granite_moe
from .rwkv6_7b import CONFIG as _rwkv6
from .chameleon_34b import CONFIG as _chameleon
from .minitron_8b import CONFIG as _minitron
from .whisper_large_v3 import CONFIG as _whisper
from .qwen3_4b import CONFIG as _qwen3
from .yi_9b import CONFIG as _yi
from .mixtral_8x7b import CONFIG as _mixtral
from .zamba2_1_2b import CONFIG as _zamba2
from .granite_34b import CONFIG as _granite34

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    _granite_moe, _rwkv6, _chameleon, _minitron, _whisper,
    _qwen3, _yi, _mixtral, _zamba2, _granite34,
]}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]

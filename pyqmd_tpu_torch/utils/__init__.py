"""Utilities: formatting, checkpointing, profiling.

The checkpoint functions load on first use: the checkpoint module needs the
parallel package, which needs the frames, and the frames need
:mod:`pyqmd_tpu_torch.utils.profiling`.
"""

from pyqmd_tpu_torch.utils.format import (
    format_half_life,
    format_time_scale,
    format_time_value,
    format_time_value_with_unit,
    parse_time_scale,
)

__all__ = [
    "format_half_life",
    "format_time_scale",
    "format_time_value",
    "format_time_value_with_unit",
    "load_checkpoint",
    "parse_time_scale",
    "save_checkpoint",
]


def __getattr__(name: str):
    if name in ("load_checkpoint", "save_checkpoint"):
        from pyqmd_tpu_torch.utils import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

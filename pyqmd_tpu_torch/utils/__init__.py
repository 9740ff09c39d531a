"""Utilities: formatting, checkpointing, profiling."""

from pyqmd_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
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

from .common import get_same_padding, int2list, make_divisible, sub_filter_start_end
from .device import resolve_device

__all__ = [
    "get_same_padding",
    "int2list",
    "make_divisible",
    "resolve_device",
    "sub_filter_start_end",
]

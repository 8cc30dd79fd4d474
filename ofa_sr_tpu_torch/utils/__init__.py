from .common import AverageMeter, get_same_padding, int2list, make_divisible, sub_filter_start_end
from .device import resolve_device
from .metrics import psnr_y_device, quantize_img, rgb2y_device

__all__ = [
    "AverageMeter",
    "get_same_padding",
    "int2list",
    "make_divisible",
    "psnr_y_device",
    "quantize_img",
    "resolve_device",
    "rgb2y_device",
    "sub_filter_start_end",
]

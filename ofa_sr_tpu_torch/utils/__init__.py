from .common import AverageMeter, get_same_padding, int2list, make_divisible, sub_filter_start_end
from .device import resolve_device
from .metrics import (
    psnr_np,
    psnr_rgb_device,
    psnr_y_device,
    quantize_img,
    rgb2gray_np,
    rgb2y_device,
    rgb2y_np,
    tensor2img_np,
)

__all__ = [
    "AverageMeter",
    "get_same_padding",
    "int2list",
    "make_divisible",
    "psnr_np",
    "psnr_rgb_device",
    "psnr_y_device",
    "quantize_img",
    "resolve_device",
    "rgb2gray_np",
    "rgb2y_device",
    "rgb2y_np",
    "sub_filter_start_end",
    "tensor2img_np",
]

from .arch import (
    SearchSpace,
    SubnetConfig,
    max_subnet,
    reference_quirk_arch_s4,
    reference_quirk_arch_x4,
    sample_subnet,
    subnet_seed,
    uniform_subnet,
)
from .materialize import StaticSubnet, get_active_subnet
from .ofa_s4 import OFAMobileNetS4
from .ofa_x4 import OFAMobileNetX4

__all__ = [
    "OFAMobileNetS4",
    "OFAMobileNetX4",
    "SearchSpace",
    "StaticSubnet",
    "SubnetConfig",
    "get_active_subnet",
    "max_subnet",
    "reference_quirk_arch_s4",
    "reference_quirk_arch_x4",
    "sample_subnet",
    "subnet_seed",
    "uniform_subnet",
]

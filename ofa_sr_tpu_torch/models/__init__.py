from .arch import (
    MaskedArch,
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
from .materialize_cls import StaticClsSubnet, get_active_cls_subnet
from .ofa_cls import ClsArch, ElasticClassifierNet, OFAMobileNetV3, OFAProxylessNASNets, StageSpec
from .ofa_s4 import OFAMobileNetS4
from .ofa_x4 import OFAMobileNetX4

__all__ = [
    "ClsArch",
    "MaskedArch",
    "ElasticClassifierNet",
    "OFAMobileNetS4",
    "OFAMobileNetV3",
    "OFAMobileNetX4",
    "OFAProxylessNASNets",
    "SearchSpace",
    "StageSpec",
    "StaticClsSubnet",
    "StaticSubnet",
    "SubnetConfig",
    "get_active_cls_subnet",
    "get_active_subnet",
    "max_subnet",
    "reference_quirk_arch_s4",
    "reference_quirk_arch_x4",
    "sample_subnet",
    "subnet_seed",
    "uniform_subnet",
]

"""Subnet search (counterpart of ofa_sr_tpu/search/): FLOPs and parameter
counts, architecture encodings, the accuracy predictor, latency tables
measured on the device, and the evolutionary finder.
`cls_subnet_flops` waits for the classification nets."""

from .accuracy_predictor import AccuracyPredictor
from .encoder import encode_cls_arch, encode_sr_subnet
from .evolution import EvolutionFinder
from .flops import FLOPsTable, count_params, s4_subnet_flops, s4_subnet_params
from .latency import (
    LatencyTable,
    build_block_latency_table,
    build_latency_table,
    lut_efficiency_fn,
    measure_latency,
    measure_latency_device,
)

__all__ = [
    "encode_cls_arch", "encode_sr_subnet",
    "AccuracyPredictor",
    "count_params", "s4_subnet_flops", "s4_subnet_params",
    "FLOPsTable",
    "LatencyTable", "measure_latency", "measure_latency_device",
    "build_latency_table", "build_block_latency_table", "lut_efficiency_fn",
    "EvolutionFinder",
]

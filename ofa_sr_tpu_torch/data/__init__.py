from .datasets import PairedImageDataset, SRImageDataset, SyntheticSRDataset, list_images
from .providers import (
    CodecDecoderProvider,
    DataProvider,
    Div2KSetXXProvider,
    ElasticResolution,
    Loader,
    OracleVideoProvider,
    SyntheticSRProvider,
)
from .transforms import (
    CenterCrop,
    Compose,
    EntropyCrop,
    ModCrop,
    NineRandomCrop,
    RandomCrop,
    RandomHorizontalFlip,
    RandomRotation,
    Scale,
    bicubic_downscale_pil,
    to_numpy,
)

__all__ = [
    "CenterCrop", "Compose", "EntropyCrop", "ModCrop", "NineRandomCrop",
    "RandomCrop", "RandomHorizontalFlip", "RandomRotation", "Scale",
    "bicubic_downscale_pil", "to_numpy",
    "PairedImageDataset", "SRImageDataset", "SyntheticSRDataset", "list_images",
    "CodecDecoderProvider", "DataProvider", "Div2KSetXXProvider", "ElasticResolution",
    "Loader", "OracleVideoProvider", "SyntheticSRProvider",
]

from .cls_providers import (
    Cifar10Dataset,
    Cifar10Provider,
    ImageFolderDataset,
    ImagenetProvider,
    SyntheticClsDataset,
    SyntheticClsProvider,
)
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
    "Cifar10Dataset", "Cifar10Provider", "ImageFolderDataset", "ImagenetProvider",
    "SyntheticClsDataset", "SyntheticClsProvider",
    "CenterCrop", "Compose", "EntropyCrop", "ModCrop", "NineRandomCrop",
    "RandomCrop", "RandomHorizontalFlip", "RandomRotation", "Scale",
    "bicubic_downscale_pil", "to_numpy",
    "PairedImageDataset", "SRImageDataset", "SyntheticSRDataset", "list_images",
    "CodecDecoderProvider", "DataProvider", "Div2KSetXXProvider", "ElasticResolution",
    "Loader", "OracleVideoProvider", "SyntheticSRProvider",
]

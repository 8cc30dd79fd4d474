"""Data providers: datasets + deterministic loaders feeding NHWC numpy
batches (counterpart of ofa_sr_tpu/data/providers.py).

The same semantics as the JAX package, so both give the same batches:
- the fixed split seeds SUB_SEED / VALID_SEED and the `torch.randperm`
  valid split;
- a per-epoch shuffle from `np.random.RandomState(epoch)`, then padding to
  a multiple of `num_replicas` and rank striding;
- each sample's random transforms from `random.Random(epoch * 1_000_003 + i)`
  (i the dataset index), so results do not depend on worker scheduling;
- `per_batch_setting(batch_id, epoch)`, the kwargs of a whole batch;
- a thread-pool prefetch of two batches.

Batches stay numpy on the host; the run manager moves each one to the
device once. `Div2KSetXXProvider(use_native=True)` trains from the native
C++ loader (data/native.py), built from csrc/loader at first use; where it
cannot be built the provider raises with the compiler's report (the JAX
package keeps its PIL loader then).
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import random
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from .datasets import PairedImageDataset, SRImageDataset, SyntheticSRDataset
from .transforms import (
    CenterCrop,
    Compose,
    ModCrop,
    RandomCrop,
    RandomHorizontalFlip,
    RandomRotation,
)


class ElasticResolution:
    """The train resolution drawn per batch, the same on every rank when
    `sync_distributed`: from `random.Random(int("%d%.3d" % (batch_id,
    epoch)))` (the reference's MyRandomResizedCrop, as an object)."""

    def __init__(self, image_size_list: Sequence[int], continuous=False,
                 sync_distributed=True):
        self.image_size_list = sorted(int2(image_size_list))
        self.continuous = continuous
        self.sync_distributed = sync_distributed

    def candidates(self) -> List[int]:
        if self.continuous:
            lo, hi = min(self.image_size_list), max(self.image_size_list)
            return [i for i in range(lo, hi + 1) if i % 4 == 0]
        return list(self.image_size_list)

    def sample(self, batch_id: int, epoch: int) -> int:
        if self.sync_distributed:
            seed = int("%d%.3d" % (batch_id, epoch))
        else:
            seed = random.randrange(2 ** 31)
        return random.Random(seed).choice(self.candidates())


def int2(v):
    return [v] if isinstance(v, int) else list(v)


def _valid_split_indices(train_size: int, valid_size: int):
    """(train, valid) indices: the reference split, a `torch.randperm` from
    VALID_SEED."""
    g = torch.Generator()
    g.manual_seed(DataProvider.VALID_SEED)
    rand_indexes = torch.randperm(train_size, generator=g).tolist()
    return rand_indexes[valid_size:], rand_indexes[:valid_size]


def _sub_sample_indices(train_size: int, n_images: int):
    """The BN-calibration subset: a `torch.randperm` from SUB_SEED."""
    g = torch.Generator()
    g.manual_seed(DataProvider.SUB_SEED)
    return torch.randperm(train_size, generator=g).tolist()[:n_images]


class Loader:
    """Deterministic, sharded, prefetching batch iterator (see the module
    docstring); yields {key: np.ndarray of shape (B, ...)}."""

    def __init__(self, dataset, batch_size: int, *, shuffle=False,
                 drop_last=False, num_replicas=1, rank=0, num_workers=8,
                 indices: Optional[Sequence[int]] = None, epoch=0,
                 per_batch_setting=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_replicas = num_replicas
        self.rank = rank
        self.num_workers = num_workers
        self.indices = list(indices) if indices is not None else list(range(len(dataset)))
        self.epoch = epoch
        self.per_batch_setting = per_batch_setting

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> List[int]:
        idx = list(self.indices)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            idx = [idx[i] for i in rng.permutation(len(idx))]
        if self.num_replicas > 1:
            n = -(-len(idx) // self.num_replicas) * self.num_replicas
            idx = (idx + idx[: n - len(idx)])[self.rank::self.num_replicas]
        return idx

    def __len__(self):
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        idx = self._epoch_indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        def load_one(i, setting):
            rng = random.Random(self.epoch * 1_000_003 + i)
            return self.dataset.__getitem__(i, rng=rng, **setting)

        def setting_for(batch_id):
            if self.per_batch_setting is None:
                return {}
            return self.per_batch_setting(batch_id, self.epoch)

        def collate(samples):
            return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

        if self.num_workers <= 1:
            for bid, b in enumerate(batches):
                st = setting_for(bid)
                yield collate([load_one(i, st) for i in b])
            return

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            def submit(bid, b):
                st = setting_for(bid)
                return pool.map(lambda i: load_one(i, st), b)

            pending = []
            it = iter(enumerate(batches))
            for _ in range(2):  # a two-batch prefetch window
                nb = next(it, None)
                if nb is not None:
                    pending.append(submit(*nb))
            while pending:
                done = pending.pop(0)
                nb = next(it, None)
                if nb is not None:
                    pending.append(submit(*nb))
                yield collate(list(done))


class DataProvider:
    """Base provider: the reference's split seeds."""

    SUB_SEED = 937162211
    VALID_SEED = 2147483647

    @staticmethod
    def name():
        raise NotImplementedError

    @property
    def data_shape(self):
        return (self.image_size, self.image_size, 3)


class _SRFolderProvider(DataProvider):
    """`<root>/train` and `<root>/val` image trees: a shuffled, drop-last
    train loader, a valid loader (a split of train when `valid_size`), and a
    sequential test loader over val."""

    def __init__(self, root, *, train_batch_size=16, test_batch_size=1,
                 valid_size=None, image_size=96, num_replicas=1, rank=0,
                 num_workers=8, train_transform=None, valid_transform=None,
                 numeric_sort=False, dataset_cls=SRImageDataset):
        self.root = root
        self.image_size = image_size
        self._train_ds = dataset_cls(os.path.join(root, "train"),
                                     transform=train_transform,
                                     numeric_sort=numeric_sort)
        self._valid_ds = dataset_cls(os.path.join(root, "val"),
                                     transform=valid_transform,
                                     numeric_sort=numeric_sort)

        train_indices, valid_indices = None, None
        if valid_size is not None:
            train_indices, valid_indices = _valid_split_indices(
                len(self._train_ds), valid_size)

        self.train = Loader(self._train_ds, train_batch_size, shuffle=True,
                            drop_last=True, num_replicas=num_replicas,
                            rank=rank, num_workers=num_workers,
                            indices=train_indices)
        if valid_indices is not None:
            self.valid = Loader(self._train_ds, test_batch_size,
                                num_workers=num_workers, indices=valid_indices)
        else:
            self.valid = Loader(self._valid_ds, test_batch_size,
                                num_workers=num_workers)
        self.test = Loader(self._valid_ds, test_batch_size,
                           num_workers=num_workers)

    def build_sub_train_loader(self, n_images, batch_size, num_workers=None):
        """Calibration subset for BN recalibration (SUB_SEED)."""
        idx = _sub_sample_indices(len(self._train_ds), n_images)
        return Loader(self._train_ds, batch_size, indices=idx,
                      num_workers=num_workers or self.train.num_workers)


class Div2KSetXXProvider(_SRFolderProvider):
    """DIV2K train / Set5+Set14 val: RandomCrop(image_size) + flip +
    rotation for train, ModCrop(4) for val."""

    DEFAULT_PATH = "/SSD/div2k_setxx"

    def __init__(self, root=None, image_size=96, use_native=False, **kw):
        super().__init__(
            root or self.DEFAULT_PATH,
            image_size=image_size,
            train_transform=Compose([RandomCrop(image_size),
                                     RandomHorizontalFlip(),
                                     RandomRotation(90)]),
            valid_transform=Compose([ModCrop(4)]),
            **kw)
        if use_native:
            from .native import NativeSRLoader
            self.train = NativeSRLoader(
                self._train_ds.paths, crop=image_size, batch_size=self.train.batch_size,
                augment=True, n_threads=self.train.num_workers)

    @staticmethod
    def name():
        return "div2k_setxx"


class OracleVideoProvider(_SRFolderProvider):
    """Video-frame dirs, numerically sorted, CenterCrop for train and valid
    (the reference's Oracle_VideoDataProvider)."""

    DEFAULT_PATH = "/SSD/kaist_paper_video_dataset"

    def __init__(self, root=None, image_size=448, **kw):
        super().__init__(
            root or self.DEFAULT_PATH,
            image_size=image_size,
            train_transform=Compose([CenterCrop(image_size)]),
            valid_transform=Compose([CenterCrop(image_size)]),
            numeric_sort=True,
            **kw)

    @staticmethod
    def name():
        return "oracle_video"


class CodecDecoderProvider(_SRFolderProvider):
    """Precomputed codec-decoded LR / pristine HR pairs,
    `<split>/image` and `<split>/label` (the reference's
    Codec_DecoderDataProvider)."""

    DEFAULT_PATH = "/SSD/uvg-1080p"

    def __init__(self, root=None, image_size=448, **kw):
        super().__init__(
            root or self.DEFAULT_PATH,
            image_size=image_size,
            train_transform=None,
            valid_transform=None,
            numeric_sort=True,
            dataset_cls=PairedImageDataset,
            **kw)

    @staticmethod
    def name():
        return "codec_decoder"


class SyntheticSRProvider(DataProvider):
    """Synthetic provider for tests and benchmarks."""

    def __init__(self, n_train=64, n_valid=8, hr_size=96, train_batch_size=16,
                 test_batch_size=1, num_replicas=1, rank=0, seed=0):
        self.image_size = hr_size
        self._train_ds = SyntheticSRDataset(n_train, hr_size, seed)
        self._valid_ds = SyntheticSRDataset(n_valid, hr_size, seed + 1)
        self.train = Loader(self._train_ds, train_batch_size, shuffle=True,
                            drop_last=True, num_replicas=num_replicas,
                            rank=rank, num_workers=1)
        self.valid = Loader(self._valid_ds, test_batch_size, num_workers=1)
        self.test = self.valid

    @staticmethod
    def name():
        return "synthetic_sr"

    def build_sub_train_loader(self, n_images, batch_size, num_workers=None):
        idx = _sub_sample_indices(len(self._train_ds), n_images)
        return Loader(self._train_ds, batch_size, indices=idx, num_workers=1)

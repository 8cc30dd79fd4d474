"""Classification data providers, CIFAR-10 / ImageNet-folder / synthetic
(counterpart of ofa_sr_tpu/data/cls_providers.py).

The ImageNet provider reads a class-per-subdirectory tree; CIFAR-10 reads
the standard python pickle batches from a local directory (nothing is
downloaded). Both have the deterministic valid split, rank sharding, the
BN-calibration subset and (ImageNet) the per-batch elastic resolution of
`ElasticResolution`, on the port's `Loader`, so the per-epoch shuffle and
every sample's draws are the JAX package's and a seed gives the same
arrays in both. PIL is imported inside the functions that open or resize
an image: the synthetic path runs without it.
"""

from __future__ import annotations

import os
import pickle
import random
from typing import Optional

import numpy as np

from .providers import (
    DataProvider,
    ElasticResolution,
    Loader,
    _sub_sample_indices,
    _valid_split_indices,
)
from .transforms import to_numpy

_IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
_CIFAR_MEAN = np.asarray([0.4914, 0.4822, 0.4465], np.float32)
_CIFAR_STD = np.asarray([0.2470, 0.2435, 0.2616], np.float32)


class Cifar10Dataset:
    """CIFAR-10 from the standard `cifar-10-batches-py` pickles: pad-4
    reflect crop and flip from the sample's `random.Random` when training,
    and a bicubic resize (PIL, uint8) when `image_size` is not 32."""

    def __init__(self, root, train=True, image_size=32, augment=True):
        base = os.path.join(root, "cifar-10-batches-py")
        files = ["data_batch_%d" % i for i in range(1, 6)] if train else ["test_batch"]
        xs, ys = [], []
        for fn in files:
            with open(os.path.join(base, fn), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        self.labels = np.asarray(ys, np.int64)
        self.train = train
        self.augment = augment and train
        self.image_size = image_size

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index, rng: Optional[random.Random] = None):
        img = self.images[index].astype(np.float32) / 255.0
        if self.augment and rng is not None:
            p = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="reflect")
            i, j = rng.randint(0, 8), rng.randint(0, 8)
            img = p[i:i + 32, j:j + 32]
            if rng.random() < 0.5:
                img = img[:, ::-1]
        img = (img - _CIFAR_MEAN) / _CIFAR_STD
        if self.image_size != 32:
            from PIL import Image
            u8 = np.clip((img * _CIFAR_STD + _CIFAR_MEAN) * 255, 0, 255).astype(np.uint8)
            img = np.asarray(Image.fromarray(u8).resize((self.image_size, self.image_size),
                                                        Image.BICUBIC), np.float32) / 255.0
            img = (img - _CIFAR_MEAN) / _CIFAR_STD
        return {"image": np.ascontiguousarray(img, np.float32), "label": self.labels[index]}


class ImageFolderDataset:
    """A class-per-subdirectory tree (torchvision ImageFolder layout):
    RandomResizedCrop(resize_scale..1, ratio 3/4..4/3) + flip when training,
    Resize(size / 0.875) + CenterCrop(size) otherwise, at the per-batch
    `size` (ElasticResolution) or `active_size`. `use_native`: decode and
    resize through the native loader (data/native.py, float32 bicubic)
    instead of PIL (uint8); both draw the same boxes from the same rng."""

    def __init__(self, root, image_size=224, train=True,
                 elastic: Optional[ElasticResolution] = None, resize_scale=0.08,
                 use_native=False):
        self.root = root
        self.use_native = use_native
        if use_native:
            from .native import native_available
            self.use_native = native_available()
        classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for fn in sorted(os.listdir(d)):
                if fn.lower().endswith((".png", ".jpg", ".jpeg")):
                    self.samples.append((os.path.join(d, fn), self.class_to_idx[c]))
        self.image_size = image_size
        self.train = train
        self.elastic = elastic
        self.resize_scale = resize_scale
        self.active_size = image_size

    def __len__(self):
        return len(self.samples)

    @staticmethod
    def _rrc_params(rng, w, h, resize_scale):
        """RandomResizedCrop's box, (j, i, cw, ch), or None after 10 misses;
        shared by both backends so both consume the rng alike."""
        area = w * h
        for _ in range(10):
            t_area = rng.uniform(resize_scale, 1.0) * area
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round((t_area * ar) ** 0.5))
            ch = int(round((t_area / ar) ** 0.5))
            if cw <= w and ch <= h:
                j, i = rng.randint(0, w - cw), rng.randint(0, h - ch)
                return j, i, cw, ch
        return None

    def _getitem_native(self, index, rng, size):
        from .native import decode_image, resize_bicubic
        path, label = self.samples[index]
        arr = decode_image(path)  # float32 HWC in [0, 1]
        h, w = arr.shape[:2]
        if self.train and rng is not None:
            box = self._rrc_params(rng, w, h, self.resize_scale)
            if box is not None:
                j, i, cw, ch = box
                arr = arr[i:i + ch, j:j + cw]
            arr = resize_bicubic(arr, size, size)
            if rng.random() < 0.5:
                arr = arr[:, ::-1]
        else:
            short = int(np.ceil(size / 0.875))
            if w < h:
                arr = resize_bicubic(arr, int(h * short / w), short)
            else:
                arr = resize_bicubic(arr, short, int(w * short / h))
            hh, ww = arr.shape[:2]
            j, i = (ww - size) // 2, (hh - size) // 2
            arr = arr[i:i + size, j:j + size]
        arr = (np.clip(arr, 0.0, 1.0) - _IMAGENET_MEAN) / _IMAGENET_STD
        return {"image": np.ascontiguousarray(arr, np.float32), "label": np.int64(label)}

    def __getitem__(self, index, rng: Optional[random.Random] = None,
                    size: Optional[int] = None):
        size = size if size is not None else self.active_size
        if self.use_native:
            return self._getitem_native(index, rng, size)
        from PIL import Image
        path, label = self.samples[index]
        img = Image.open(path).convert("RGB")
        if self.train and rng is not None:
            w, h = img.size
            box = self._rrc_params(rng, w, h, self.resize_scale)
            if box is not None:
                j, i, cw, ch = box
                img = img.crop((j, i, j + cw, i + ch))
            img = img.resize((size, size), Image.BICUBIC)
            if rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            short = int(np.ceil(size / 0.875))
            w, h = img.size
            if w < h:
                img = img.resize((short, int(h * short / w)), Image.BICUBIC)
            else:
                img = img.resize((int(w * short / h), short), Image.BICUBIC)
            w, h = img.size
            j, i = (w - size) // 2, (h - size) // 2
            img = img.crop((j, i, j + size, i + size))
        arr = (to_numpy(img) - _IMAGENET_MEAN) / _IMAGENET_STD
        return {"image": arr.astype(np.float32), "label": np.int64(label)}


class SyntheticClsDataset:
    """Seeded uniform images and labels index % n_classes, the JAX
    package's arrays for the same seed and index."""

    def __init__(self, n=128, image_size=32, n_classes=10, seed=0):
        self.n = n
        self.image_size = image_size
        self.n_classes = n_classes
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index, rng=None):
        r = np.random.RandomState(self.seed * 99991 + index)
        return {"image": r.rand(self.image_size, self.image_size, 3).astype(np.float32),
                "label": np.int64(index % self.n_classes)}


class _ClsProvider(DataProvider):
    def _finish(self, train_ds, test_ds, train_batch_size, test_batch_size, valid_size,
                num_replicas, rank, num_workers):
        train_indices, valid_indices = None, None
        if valid_size is not None:
            train_indices, valid_indices = _valid_split_indices(len(train_ds), valid_size)
        self._train_ds = train_ds
        self.train = Loader(train_ds, train_batch_size, shuffle=True, drop_last=True,
                            num_replicas=num_replicas, rank=rank, num_workers=num_workers,
                            indices=train_indices)
        if valid_indices is not None:
            self.valid = Loader(train_ds, test_batch_size, indices=valid_indices,
                                num_workers=num_workers)
        else:
            self.valid = Loader(test_ds, test_batch_size, num_workers=num_workers)
        self.test = Loader(test_ds, test_batch_size, num_workers=num_workers)

    def build_sub_train_loader(self, n_images, batch_size, num_workers=1):
        """The BN-calibration subset (SUB_SEED) of the training set."""
        idx = _sub_sample_indices(len(self._train_ds), n_images)
        return Loader(self._train_ds, batch_size, indices=idx, num_workers=num_workers)


class Cifar10Provider(_ClsProvider):
    DEFAULT_PATH = "/dataset/cifar10"
    n_classes = 10

    def __init__(self, root=None, image_size=32, train_batch_size=256, test_batch_size=256,
                 valid_size=None, num_replicas=1, rank=0, num_workers=4):
        root = root or self.DEFAULT_PATH
        self.image_size = image_size
        self._finish(Cifar10Dataset(root, True, image_size),
                     Cifar10Dataset(root, False, image_size),
                     train_batch_size, test_batch_size, valid_size, num_replicas, rank,
                     num_workers)

    @staticmethod
    def name():
        return "cifar10"


class ImagenetProvider(_ClsProvider):
    """`<root>/train` and `<root>/val` class trees; with `elastic`, every
    training batch at the resolution `elastic.sample(batch_id, epoch)`
    draws, the same on every rank."""

    DEFAULT_PATH = "/dataset/imagenet"
    n_classes = 1000

    def __init__(self, root=None, image_size=224, train_batch_size=256, test_batch_size=256,
                 valid_size=None, num_replicas=1, rank=0, num_workers=8,
                 elastic: Optional[ElasticResolution] = None, resize_scale=0.08,
                 use_native=False):
        root = root or self.DEFAULT_PATH
        self.image_size = image_size
        self.elastic = elastic
        train_ds = ImageFolderDataset(os.path.join(root, "train"), image_size, True, elastic,
                                      resize_scale, use_native=use_native)
        test_ds = ImageFolderDataset(os.path.join(root, "val"), image_size, False,
                                     use_native=use_native)
        self._finish(train_ds, test_ds, train_batch_size, test_batch_size, valid_size,
                     num_replicas, rank, num_workers)
        if elastic is not None:
            self.train.per_batch_setting = (
                lambda batch_id, epoch: {"size": elastic.sample(batch_id, epoch)})

    def assign_active_img_size(self, size):
        """The training set's resolution where no per-batch size is set
        (the reference's assign_active_img_size)."""
        self._train_ds.active_size = size

    @staticmethod
    def name():
        return "imagenet"


class SyntheticClsProvider(_ClsProvider):
    def __init__(self, n_train=128, n_test=32, image_size=32, n_classes=10,
                 train_batch_size=32, test_batch_size=32, num_replicas=1, rank=0, seed=0):
        self.image_size = image_size
        self.n_classes = n_classes
        self._finish(SyntheticClsDataset(n_train, image_size, n_classes, seed),
                     SyntheticClsDataset(n_test, image_size, n_classes, seed + 1),
                     train_batch_size, test_batch_size, None, num_replicas, rank, 1)

    @staticmethod
    def name():
        return "synthetic_cls"

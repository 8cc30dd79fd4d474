"""ctypes binding of the native C++ loader (counterpart of
ofa_sr_tpu/data/native.py): PNG/PPM/JPEG decode, PIL-compatible bicubic
resize, and a threaded SR-sample loader (decode, crop/flip/rotate, 2x and
4x downscale) over the sources in csrc/loader.

The library is compiled at first use with csrc/Makefile's flags (`g++ -O3
-fPIC -std=c++17 -pthread -shared -lz -ljpeg`) into build/native/ beside
the package (listed in .gitignore; nothing is written into csrc/), under a
file lock, since several processes may import it at once. Its file name
carries a hash of the sources and flags, so an edited source is rebuilt.
The ctypes signatures are the JAX package's.

`native_available()` says whether the library builds and loads; the other
entry points raise with the compiler's report when it does not. Host code:
it needs g++ and the zlib and libjpeg headers, not the GPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC_DIR = os.path.join(_REPO_ROOT, "csrc", "loader")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
SOURCES = ("image.cc", "loader.cc")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread"]
LD_FLAGS = ["-shared", "-pthread", "-lz", "-ljpeg"]

_lock = threading.Lock()
_LIB = None
_ERROR = None   # the build's or the load's report, once it failed


def _lib_path():
    h = hashlib.sha1(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    for name in SOURCES + ("image.h",):
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "libofa_loader_%s.so" % h.hexdigest()[:12])


def _build(out):
    """Compile the library into `out` unless another process already has;
    returns None, or the failure's report."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if os.path.exists(out):
                return None
            tmp = "%s.%d.tmp" % (out, os.getpid())
            cmd = (["g++"] + CXX_FLAGS + [os.path.join(_SRC_DIR, s) for s in SOURCES]
                   + ["-o", tmp] + LD_FLAGS)
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                return "g++ not found: %s" % e
            if res.returncode != 0:
                return "%s failed (rc %d):\n%s" % (" ".join(cmd), res.returncode, res.stderr)
            os.replace(tmp, out)
            return None
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _declare(lib):
    c_int, c_float_p, c_vp = ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_void_p
    lib.ofa_image_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(c_int),
                                   ctypes.POINTER(c_int)]
    lib.ofa_image_dims.restype = c_int
    lib.ofa_decode_image.argtypes = [ctypes.c_char_p, c_float_p]
    lib.ofa_decode_image.restype = c_int
    lib.ofa_resize_bicubic.argtypes = [c_float_p, c_int, c_int, c_int, c_float_p, c_int, c_int]
    lib.ofa_resize_bicubic.restype = c_int
    lib.ofa_loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), c_int, c_int, c_int,
                                      c_int, c_int]
    lib.ofa_loader_create.restype = c_vp
    lib.ofa_loader_start_epoch.argtypes = [c_vp, ctypes.c_uint64]
    lib.ofa_loader_start_epoch.restype = None
    lib.ofa_loader_n_batches.argtypes = [c_vp]
    lib.ofa_loader_n_batches.restype = ctypes.c_long
    lib.ofa_loader_next.argtypes = [c_vp, c_float_p, c_float_p, c_float_p]
    lib.ofa_loader_next.restype = c_int
    lib.ofa_loader_destroy.argtypes = [c_vp]
    lib.ofa_loader_destroy.restype = None


def load():
    """The loaded library, built on first use; raises RuntimeError with the
    compiler's (or the loader's) report when it cannot be had."""
    global _LIB, _ERROR
    with _lock:
        if _LIB is None and _ERROR is None:
            out = _lib_path()
            _ERROR = _build(out)
            if _ERROR is None:
                try:
                    lib = ctypes.CDLL(out)
                    _declare(lib)
                    _LIB = lib
                except OSError as e:
                    _ERROR = "loading %s failed: %s" % (out, e)
        if _LIB is None:
            raise RuntimeError("the native loader is unavailable: " + _ERROR)
        return _LIB


def native_available() -> bool:
    try:
        load()
    except RuntimeError:
        return False
    return True


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_image(path: str) -> np.ndarray:
    """PNG/PPM/JPEG -> float32 HWC in [0, 1]."""
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.ofa_image_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError("native decode failed: %s" % path)
    out = np.empty((h.value, w.value, 3), np.float32)
    if lib.ofa_decode_image(path.encode(), _ptr(out)) != 0:
        raise IOError("native decode failed: %s" % path)
    return out


def resize_bicubic(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """PIL-compatible bicubic on a float32 HWC array."""
    lib = load()
    src = np.ascontiguousarray(src, np.float32)
    sh, sw, c = src.shape
    dst = np.empty((dh, dw, c), np.float32)
    lib.ofa_resize_bicubic(_ptr(src), sh, sw, c, _ptr(dst), dh, dw)
    return dst


class NativeSRLoader:
    """Threaded native batch loader over HR image files, yielding
    {"image", "x2", "x4"} NHWC float32 batches: random crop, flip and
    rotation with its own deterministic RNG per epoch when `augment`
    (incomplete batches dropped), else ModCrop(4), batch 1 unless every
    image has one size."""

    def __init__(self, paths, crop=96, batch_size=16, augment=True, n_threads=4):
        lib = load()
        self._lib = lib
        self.paths = list(paths)
        self.crop = crop
        self.batch_size = batch_size
        self.augment = augment
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._handle = lib.ofa_loader_create(arr, len(self.paths), crop, batch_size,
                                             int(augment), n_threads)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.augment:
            return len(self.paths) // self.batch_size
        return -(-len(self.paths) // self.batch_size)

    def __iter__(self):
        lib = self._lib
        lib.ofa_loader_start_epoch(self._handle, self.epoch)
        cs = self.crop
        while True:
            hr = np.empty((self.batch_size, cs, cs, 3), np.float32)
            x2 = np.empty((self.batch_size, cs // 2, cs // 2, 3), np.float32)
            x4 = np.empty((self.batch_size, cs // 4, cs // 4, 3), np.float32)
            n = lib.ofa_loader_next(self._handle, _ptr(hr), _ptr(x2), _ptr(x4))
            if n <= 0:
                if n < 0:
                    raise IOError("native loader batch failed")
                return
            yield {"image": hr[:n], "x2": x2[:n], "x4": x4[:n]}

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.ofa_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

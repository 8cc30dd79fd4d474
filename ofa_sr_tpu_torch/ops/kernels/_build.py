"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC` into `build/ofa_sr_tpu_torch/` beside the package (listed in
.gitignore), then loaded with ctypes. The library's file name carries a hash
of its source and flags, so an edited source is rebuilt and an unchanged one
is reused. `build_all()` starts one nvcc per source, all at once.

Only the sources in this checkout are used: no other library is linked
beyond the CUDA runtime.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "ofa_sr_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
ptxas_log = {}   # name -> nvcc's stderr (register / shared-memory report)


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name):
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, "lib%s_%s.so" % (name, digest))


def _start(name):
    src, out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, out


def _finish(name, job):
    """Wait for one nvcc; returns its error report, or None on success."""
    if job is None:
        return None
    proc, tmp, out = job
    stdout, stderr = proc.communicate()
    ptxas_log[name] = stderr
    if proc.returncode != 0:
        return "nvcc failed for %s.cu (rc %d):\n%s%s" % (
            name, proc.returncode, stdout, stderr)
    os.replace(tmp, out)
    return None


_VP, _INT = ctypes.c_void_p, ctypes.c_int
# each launch function, by C name: its source, then its argument types:
# pointers (tensors), ints (shapes, flags), then the CUDA stream; it returns
# the cudaError_t of its launches
_FUNCTIONS = {
    "ofa_mbconv_f32": ("mbconv", [_VP] * 8 + [_INT] * 7 + [_VP]),
    "ofa_shuffle_tail_f32": ("shuffle_tail", [_VP] * 4 + [_INT] * 5 + [_VP]),
    "ofa_col_sums2_f32": ("bn_stats", [_VP] * 6 + [_INT] * 4 + [_VP]),
    "ofa_bn_backward_f32": ("bn_stats", [_VP] * 9 + [_INT] * 3 + [_VP]),
    "ofa_col_sums2_bf16": ("bn_stats", [_VP] * 6 + [_INT] * 4 + [_VP]),
    "ofa_bn_backward_bf16": ("bn_stats", [_VP] * 9 + [_INT] * 3 + [_VP]),
}
SOURCES = tuple(sorted({src for src, _ in _FUNCTIONS.values()}))
_fns = {}   # C name -> the bound ctypes function


def _declare(name, lib):
    for fn_name, (src, argtypes) in _FUNCTIONS.items():
        if src == name:
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = argtypes, _INT
            _fns[fn_name] = fn
    lib.ofa_cuda_error_string.argtypes = [_INT]
    lib.ofa_cuda_error_string.restype = ctypes.c_char_p


def build_all():
    """Compile every source that has no up-to-date library, in parallel, and
    load them all. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {n: _start(n) for n in SOURCES if n not in _libs}
        # wait for every compiler before reporting any failure
        errors = [e for e in (_finish(n, job) for n, job in jobs.items()) if e]
        if errors:
            raise RuntimeError("\n".join(errors))
        for n in jobs:
            lib = ctypes.CDLL(_lib_path(n)[1])
            _declare(n, lib)
            _libs[n] = lib
    return time.perf_counter() - t0


def load(name):
    """The loaded library for csrc/<name>.cu, building it on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def require_cuda(device, dtype, **tensors):
    """Raise unless every tensor is a contiguous `dtype` tensor on `device`
    (a CUDA device): what the kernels take, since they read raw pointers."""
    if device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, got %s" % device)
    index = device.index
    for name, t in tensors.items():
        # attribute reads, not device objects: this runs on every launch
        if not (t.is_cuda and t.get_device() == index and t.dtype is dtype
                and t.is_contiguous()):
            raise ValueError(
                "%s must be a contiguous %s tensor on %s; got %s %s "
                "contiguous=%s" % (name, dtype, device, t.dtype, t.device,
                                   t.is_contiguous()))


def require_cuda_f32(device, **tensors):
    require_cuda(device, torch.float32, **tensors)


def serving_operands(kernel, x, weights):
    """The serving kernels' operand rule, the Pallas kernels': x must be
    float32 (Pallas writes x into a float32 scratch and refuses a bf16 x);
    bf16 weights are taken as float32, which is exact (Pallas' `jnp.dot`
    promotes them the same way). Returns the weights, bf16 ones upcast."""
    if x.dtype is not torch.float32:
        raise ValueError("%s takes a float32 x, got %s: the Pallas kernel refuses it too "
                         "(it stores x into a float32 scratch)" % (kernel, x.dtype))
    return [w.float() if w.dtype is torch.bfloat16 else w for w in weights]


def launch(fn_name, device, *args):
    """Call the launch function `fn_name` of csrc/ on the current stream of
    `device` and raise on the cudaError_t it returns. `args` are, in the C
    order, tensors (passed as their data pointers), ints (shapes, flags, or
    pointers already offset into a tensor) and None (a null pointer).

    Its host cost counts: a BN wrapper runs ~130 times a training step, so
    the current stream's handle is read as an int (no `Stream` object) and
    no device context is entered unless `device` is not the current one."""
    fn = _fns.get(fn_name)
    if fn is None:
        load(_FUNCTIONS[fn_name][0])
        fn = _fns[fn_name]
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    index = device.index
    if index == torch.cuda.current_device():
        rc = fn(*c_args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*c_args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        lib = _libs[_FUNCTIONS[fn_name][0]]
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            fn_name, rc, lib.ofa_cuda_error_string(rc).decode()))

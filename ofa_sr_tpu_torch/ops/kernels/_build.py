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
# each library's launch function: pointers (tensors), ints (shapes, flags),
# then the CUDA stream; it returns the cudaError_t of the launch
_SIGNATURES = {
    "mbconv": ("ofa_mbconv_f32", [_VP] * 8 + [_INT] * 7 + [_VP]),
    "shuffle_tail": ("ofa_shuffle_tail_f32", [_VP] * 4 + [_INT] * 5 + [_VP]),
    "bn_stats": ("ofa_col_sums2_f32", [_VP] * 6 + [_INT] * 5 + [_VP]),
}
SOURCES = tuple(_SIGNATURES)


def _declare(name, lib):
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = argtypes, _INT
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


def require_cuda_f32(device, **tensors):
    """Raise unless every tensor is a contiguous float32 tensor on `device`
    (a CUDA device): what the kernels take, since they read raw pointers."""
    if device.type != "cuda":
        raise ValueError("the CUDA kernels take CUDA tensors, got %s" % device)
    for name, t in tensors.items():
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                "%s must be a contiguous float32 tensor on %s; got %s %s "
                "contiguous=%s" % (name, device, t.dtype, t.device,
                                   t.is_contiguous()))


def launch(name, *args):
    """Call csrc/<name>.cu's launch function on the current stream of the
    tensors' device and raise on the cudaError_t it returns.
    `args` are the tensors (as pointers) and ints, in the C order."""
    lib = load(name)
    fn = getattr(lib, _SIGNATURES[name][0])
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                  for a in args], stream)
    if rc != 0:
        raise RuntimeError("%s kernel: CUDA error %d (%s)" % (
            name, rc, lib.ofa_cuda_error_string(rc).decode()))

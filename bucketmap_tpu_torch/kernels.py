"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by its own `nvcc` for sm_90a, all at once, and
the objects are linked into one shared library with a plain C
interface, bound with ctypes. The build goes to
`csrc/build/<hash of sources and flags>/` at first use, so a changed
source rebuilds and an unchanged one is loaded as is. Nothing is built
or imported when this module is imported.

`LAUNCHES` counts, per kernel, the launches its wrapper made: a wrapper
adds one where it launches its kernel and nowhere else, so a run can
show that its path went through the kernels. With `SYNC_AFTER_LAUNCH`
(set by `utils.debug.validation_mode`) `check` also synchronises after
each launch, so a fault raises at the kernel that caused it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("coarse_score.cu", "fine_window.cu", "fine_scan.cu", "tally.cu",
           "dp_fwd.cu", "presence_gather.cu", "chunk_scan.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
KERNELS = ("coarse_score", "fine_search", "fine_window", "fine_scan", "tally",
           "dp_fwd", "dp_runs", "presence_gather", "chunk_scan")

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_INFO: dict = {}
SYNC_AFTER_LAUNCH = False

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def nvcc() -> str | None:
    """Path of the CUDA compiler ($CUDA_HOME/bin, then PATH, then the
    toolkit's default location), or None when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    return None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources unless this exact build exists; returns the
    library path. Raises with nvcc's output when compilation fails."""
    out_dir = os.path.join(CSRC, "build", source_hash())
    so = os.path.join(out_dir, "libbmtorch_kernels.so")
    if os.path.exists(so):
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("log", "")
        BUILD_INFO["path"] = so
        return so
    os.makedirs(out_dir, exist_ok=True)
    compiler = nvcc()
    if compiler is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit")
    t0 = time.perf_counter()
    objs, procs = [], []
    for name in SOURCES:
        obj = os.path.join(out_dir, f"{name}.{os.getpid()}.o")
        cmd = [compiler, *NVCC_FLAGS, "-c", os.path.join(CSRC, name), "-o",
               obj]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            for _, other in procs:
                other.communicate()
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = [compiler, "-shared", "-o", tmp, *objs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, so)
    for obj in objs:
        os.remove(obj)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      log="".join(log) + res.stdout + res.stderr, path=so)
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.bm_coarse_score.argtypes = [p, i64, p, i64, i32, i32, i32,
                                            ctypes.c_int32, p, p, p, p]
            lib.bm_coarse_score.restype = i32
            lib.bm_fine_window.argtypes = [p, i64, p, p, p, p, i64, i32, i32,
                                           p, p]
            lib.bm_fine_window.restype = i32
            lib.bm_fine_search.argtypes = [p, i64, i64, p, i64, p, p, p, i64,
                                           p, p, p, i64, i32, i32, i32, i32,
                                           p, p, p]
            lib.bm_fine_search.restype = i32
            lib.bm_fine_scan.argtypes = [p, i64, i64, i64, p, p, p, p, i64,
                                         p, p, p, i64, i32, i32, i32, p, p,
                                         p]
            lib.bm_fine_scan.restype = i32
            lib.bm_tally.argtypes = [p, p, i64, i32, i32, i32, i32, i32, p, p,
                                     p, p]
            lib.bm_tally.restype = i32
            lib.bm_dp_fwd.argtypes = [p, p, p, p, i64, i32, i32, i32, i32, p,
                                      p, p]
            lib.bm_dp_fwd.restype = i32
            lib.bm_dp_runs.argtypes = [p, p, p, p, i64, i32, i32, i32, i32,
                                       i32, i32, i32, p, p, p, p]
            lib.bm_dp_runs.restype = i32
            lib.bm_dp_runs_scratch_bytes.argtypes = [i64, i32, i32, i32]
            lib.bm_dp_runs_scratch_bytes.restype = i64
            lib.bm_presence_gather.argtypes = [p, i64, p, i64, i32, p, p]
            lib.bm_presence_gather.restype = i32
            lib.bm_chunk_scan.argtypes = [p, i64, i32, i64, i32,
                                          ctypes.c_int32, p, p, p, p]
            lib.bm_chunk_scan.restype = i32
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if kernel `name` failed to launch; under SYNC_AFTER_LAUNCH
    also wait for it and raise if it faulted on the device."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    if SYNC_AFTER_LAUNCH:
        import torch
        try:
            torch.cuda.synchronize()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA kernel {name} faulted: {e}") from e


def stream_handle(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, dtype, shape=None) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")

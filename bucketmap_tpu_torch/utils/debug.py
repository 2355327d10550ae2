"""Kernel validation, tracing and resource accounting.

The port's counterpart of `bucketmap_tpu/utils/debug.py`:

  * ``resource_report()`` — peak host RSS and the device memory peak,
    the JAX function's four keys (the reference harness records wall
    time and maximum resident set size of every run).
  * ``hbm_sample(*tensors)`` — sample the device's allocated bytes (on
    the CPU: the bytes of the tensors handed in) into a process-wide
    watermark that ``resource_report`` falls back on.
  * ``maybe_trace(trace_dir)`` — torch.profiler over the enclosed block,
    a Chrome trace written into ``trace_dir``; a no-op for None. Only the
    argument switches it: no environment variable is read.
  * ``validation_mode()`` — every CUDA kernel wrapper synchronises after
    its launch and raises naming that kernel, so an asynchronous fault
    surfaces at the launch that caused it.
  * ``checked(fn)`` — call fn and return (error, result), as checkify
    does, with out-of-range indexing reported as "out-of-bounds".
  * ``no_stage(name)`` — the default stage hook of the step, the
    pipeline and the aligner: a context that does nothing (a profiler
    puts an experiments.stages.StageClock in its place).
"""

from __future__ import annotations

import contextlib
import os
import time

_watermark_bytes = 0


def no_stage(name: str):
    """The default stage hook: a context that does nothing."""
    return contextlib.nullcontext()


def _cuda_in_use() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def maybe_trace(trace_dir: str | os.PathLike | None = None):
    """Profile the enclosed block with torch.profiler when `trace_dir` is
    given, yielding the profiler (its `key_averages()` and `events()` are
    readable after the block) and writing `trace_<pid>_<ns>.json`, a
    Chrome trace, into `trace_dir`. With None it yields None and costs
    nothing."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        str(trace_dir), f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def validation_mode():
    """Inside the block every kernel wrapper of `kernels.py` calls
    torch.cuda.synchronize() after its launch and raises a RuntimeError
    naming the kernel if the device reports a fault. On a machine without
    CUDA no kernel launches, and it only yields."""
    import torch

    if not torch.cuda.is_available():
        yield
        return
    from bucketmap_tpu_torch import kernels

    prev = kernels.SYNC_AFTER_LAUNCH
    kernels.SYNC_AFTER_LAUNCH = True
    try:
        yield
    finally:
        kernels.SYNC_AFTER_LAUNCH = prev


def hbm_sample(*tensors) -> int:
    """Fold the current device bytes into a process-wide watermark and
    return them: `torch.cuda.memory_allocated()` once CUDA is in use,
    else the bytes of the tensors handed in. Call it at batch boundaries;
    `resource_report` reports the watermark where the device exposes no
    memory statistics."""
    global _watermark_bytes
    if _cuda_in_use():
        import torch

        now = int(torch.cuda.memory_allocated())
    else:
        now = sum(t.numel() * t.element_size() for t in tensors)
    _watermark_bytes = max(_watermark_bytes, now)
    return now


def resource_report() -> dict:
    """{"peak_host_rss_kb": int, "device_hbm_peak_bytes": int | None,
    "device_hbm_peak_source": str | None, "device_hbm_limit_bytes": int |
    None}: peak RSS from getrusage; once CUDA is in use, the device peak
    from `torch.cuda.max_memory_allocated` (source "memory_stats") and
    the card's total memory; else the `hbm_sample` watermark (source
    "hbm_sample", no limit); else None (a CPU process never sampled)."""
    import resource

    out = {"peak_host_rss_kb": int(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss),
        "device_hbm_peak_bytes": None, "device_hbm_peak_source": None,
        "device_hbm_limit_bytes": None}
    if _cuda_in_use():
        import torch

        dev = torch.cuda.current_device()
        out["device_hbm_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
        out["device_hbm_peak_source"] = "memory_stats"
        out["device_hbm_limit_bytes"] = int(
            torch.cuda.get_device_properties(dev).total_memory)
    elif _watermark_bytes:
        out["device_hbm_peak_bytes"] = _watermark_bytes
        out["device_hbm_peak_source"] = "hbm_sample"
    return out


class CheckError:
    """The error half of `checked`'s result: `get()` is None or the
    message; `throw()` raises it."""

    def __init__(self, message: str | None = None):
        self._message = message

    def get(self) -> str | None:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise IndexError(self._message)


def checked(fn):
    """Wrap fn so a call returns (CheckError, result), the shape of a
    checkified function: an out-of-range index on the CPU (torch raises
    IndexError, or a RuntimeError saying "out of bounds") becomes an
    error whose message contains "out-of-bounds", with result None.

    On the card an out-of-range index is a device-side assert. It poisons
    the CUDA context, which cannot be recovered inside the process, so it
    is never caught here: the wrapper synchronises after fn, and the
    assert propagates as the RuntimeError torch raises."""

    def run(*args, **kwargs):
        try:
            result = fn(*args, **kwargs)
            if _cuda_in_use():
                import torch

                torch.cuda.synchronize()
        except IndexError as e:
            return CheckError(f"out-of-bounds indexing: {e}"), None
        except RuntimeError as e:
            msg = str(e)
            if "device-side assert" in msg or not (
                    "out of bounds" in msg or "out of range" in msg):
                raise
            return CheckError(f"out-of-bounds indexing: {msg}"), None
        return CheckError(), result

    return run

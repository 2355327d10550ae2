"""The port's utils/debug.py against the JAX package's: resource_report's
keys and fallback, hbm_sample, maybe_trace, checked and validation_mode,
on the CPU."""

import os

import pytest
import torch

from bucketmap_tpu.utils import debug as jax_debug
from bucketmap_tpu_torch import kernels
from bucketmap_tpu_torch.utils import debug


def test_resource_report_keys_and_cpu_fallback(monkeypatch):
    monkeypatch.setattr(debug, "_watermark_bytes", 0)
    r = debug.resource_report()
    assert set(r) == set(jax_debug.resource_report())
    assert r["peak_host_rss_kb"] > 1000
    assert (r["device_hbm_peak_bytes"], r["device_hbm_peak_source"],
            r["device_hbm_limit_bytes"]) == (None, None, None)
    x = torch.ones((128, 128))
    y = torch.zeros(10, dtype=torch.int64)
    now = debug.hbm_sample(x, y)
    assert now == x.numel() * 4 + 80
    assert debug.hbm_sample(y) == 80          # the watermark keeps the max
    r2 = debug.resource_report()
    assert r2["device_hbm_peak_bytes"] == now
    assert r2["device_hbm_peak_source"] == "hbm_sample"
    assert r2["device_hbm_limit_bytes"] is None


def test_maybe_trace_writes_a_trace_only_when_asked(tmp_path):
    with debug.maybe_trace(None) as prof:
        torch.ones(8).cumsum(0)
    assert prof is None
    d = tmp_path / "trace"
    with debug.maybe_trace(d) as prof:
        torch.ones(8).cumsum(0)
    names = os.listdir(d)
    assert len(names) == 1 and names[0].endswith(".json")
    assert (d / names[0]).stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("op", [
    lambda i: torch.zeros(4)[i],
    lambda i: torch.zeros(4).gather(0, torch.tensor([i])),
    lambda i: torch.zeros(4).take(torch.tensor([i])),
], ids=["getitem", "gather", "take"])
def test_checked_reports_out_of_bounds(op):
    import jax
    import jax.numpy as jnp

    jax_f = jax.jit(lambda i: jnp.zeros(4).at[i].get())
    for i in (2, 17):
        err, res = debug.checked(op)(i)
        jerr, _ = jax_debug.checked(jax_f)(jnp.int32(i))
        assert (err.get() is None) == (jerr.get() is None)
        if i == 2:
            assert err.get() is None and float(res.sum()) == 0.0
            err.throw()
        else:
            assert "out-of-bounds" in err.get() and res is None
            with pytest.raises(IndexError, match="out-of-bounds"):
                err.throw()


def test_checked_passes_other_errors_through():
    def bad(_):
        raise RuntimeError("shape mismatch")
    with pytest.raises(RuntimeError, match="shape mismatch"):
        debug.checked(bad)(0)


def test_validation_mode_yields_on_the_cpu():
    with debug.validation_mode():
        x = torch.tensor([1.0, 2.0]) + 1
        assert kernels.SYNC_AFTER_LAUNCH is False
    assert x.tolist() == [2.0, 3.0]


def test_sync_after_launch_names_the_faulting_kernel(monkeypatch):
    """What validation_mode switches on: kernels.check waits for the
    launch and raises naming the kernel (the device's fault stood in for
    by a synchronize that raises)."""
    calls = []

    def fault():
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(torch.cuda, "synchronize", fault)
    kernels.check(0, "tally")                 # off: no wait
    assert not calls
    monkeypatch.setattr(kernels, "SYNC_AFTER_LAUNCH", True)
    with pytest.raises(RuntimeError, match="CUDA kernel tally faulted.*"
                       "illegal memory access"):
        kernels.check(0, "tally")
    with pytest.raises(RuntimeError, match="fine_window failed to launch"):
        kernels.check(700, "fine_window")
    assert calls == [1]

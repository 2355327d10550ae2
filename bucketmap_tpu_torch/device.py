"""Explicit device handling and uint32-as-int32 helpers.

torch's uint32 lacks shifts, max and popcount on the CPU, so 32-bit
words (occupancy rows, bit planes, packed fine slots) are carried as
int32 bit patterns: AND/OR/XOR/NOT are the same bits either way, and a
right shift goes through `srl`, never `>>`. Values that need the full
unsigned range in arithmetic (k-mer hashes, packed reads, result words)
are carried as int64 holding 0 <= x < 2^32. The sentinel 0xFFFFFFFF is
-1 as an int32.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises when CUDA is asked for and absent.
    Nothing here picks a device: the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"false; pass device='cpu' to run the plain versions on the CPU")
    return dev


def u32_to_i32(a: np.ndarray) -> np.ndarray:
    """uint32 numpy array -> the same bits as int32 (no copy when possible)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """CPU tensor over a numpy array (copied when the array is read-only,
    e.g. a memory-mapped index table)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def upload_u32(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words -> device int32 bit patterns."""
    return host_tensor(u32_to_i32(a)).to(device)


def i64_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 0 <= x < 2^32 -> int32 with the same low 32 bits."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by a constant 0 <= n < 32."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit words (int32 bit patterns or int64 in
    [0, 2^32)), as int32. Runs in int64 so no step can overflow."""
    x = x.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)

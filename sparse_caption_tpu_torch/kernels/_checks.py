"""Argument checks shared by the kernel wrappers (run on every call, CPU or GPU)."""

from __future__ import annotations

import torch

FLOATS = (torch.float32, torch.bfloat16)


def check_float(t: torch.Tensor, name: str) -> None:
    if t.dtype not in FLOATS:
        raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_tensor(t: torch.Tensor, name: str, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


# the head widths the attention kernels (K1, K7, K2, K3, K14, K15) are built
# for: 64 (d_model 512 over 8 heads), 32 (ACORT-small's and ORT-small's
# d_model 256 over 8 heads) and 13 (ORT-xsmall's d_model 104 over 8 heads,
# staged at width 16: ``padded_width``)
HEAD_WIDTHS = (13, 32, 64)


def padded_width(dk: int) -> int:
    """The width the kernels stage and compute a head row at (csrc/common.cuh
    kPad): dk rounded up to the mma k-step of 16; 16 at dk 13, whose columns
    13-15 are zeros."""
    return 16 * -(-dk // 16)


def envelope_cap(nbytes: int) -> int:
    """The most bytes the 16-byte envelope of a span of `nbytes` bytes takes
    (csrc/vec.cuh envelope_cap: the aligned 16-byte blocks that hold a span
    that starts at most 15 bytes into its first)."""
    return (nbytes + 15) // 16 * 16 + 16


def check_head_width(dk: int, kernel: str) -> None:
    if dk not in HEAD_WIDTHS:
        raise ValueError(f"{kernel} kernels take head widths {HEAD_WIDTHS}; got dk={dk}")


def check_same_device(*tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")

"""K16: the magnitude-pruning threshold and masks (``csrc/magnitude_threshold.cu``).

``magnitude_masks(weights, pools, q, dist)`` gives every weight tensor its
new 0/1 mask ``criterion > threshold[pool]``, where a pool's threshold is
``jnp.quantile(criteria of the pool, q)`` as the JAX package computes it
(``update_masks_once_device``): the criterion is ``|w|``, or with ``dist``
``|(w - mean(w)) / std(w)|`` with each tensor's own mean and biased std; the
quantile interpolates between the order statistics at ranks ``lo`` and
``hi`` of the sorted pool, with ``lo``, ``hi`` and both weights computed in
f32 (``quantile_index``) and the threshold as two f32 products and one add.

CUDA tensors launch the kernel (a radix select of the two order statistics
of every pool over the criteria's f32 bits, then one pass that writes the
masks); CPU tensors run ``magnitude_masks_plain``, which sorts each pool.
Nothing else falls back.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_same_device, check_tensor

KERNEL = _build.CudaKernel("magnitude_threshold", "sct_magnitude_threshold", [
    _build.P, _build.I, _build.I, _build.I64, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
    _build.P, _build.P,
])
MAX_TENSORS = 128  # tensors of one group: the kernels' table is their parameter (csrc kMaxTensors)
CHUNK = 16384  # weights a block takes in a pass (csrc kChunk)
BINS = 2048  # histogram bins of a radix pass (11, 11 and 10 bits)
PASSES = 3


def quantile_index(n: int, q: float) -> Tuple[int, int, np.float32, np.float32]:
    """(lo, hi, low weight, high weight) of ``jnp.quantile(x, q)`` over n
    values, in the f32 arithmetic of jax's ``_quantile`` (linear method):
    ``pos = q (n - 1)`` with n and q in f32, ``lo = floor(pos)``, ``hi =
    ceil(pos)``, ``hw = pos - lo``, ``lw = 1 - hw``, both indices clamped to
    [0, n - 1]. ``q`` is rounded to f32 first, as a Python float entering a
    jitted function is."""
    f32 = np.float32
    nf, qf = f32(n), f32(q)
    pos = f32(qf * f32(nf - f32(1)))
    low, high = np.floor(pos), np.ceil(pos)
    hw = f32(pos - low)
    lw = f32(f32(1) - hw)
    last = f32(nf - f32(1))
    low = min(max(low, f32(0)), last)
    high = min(max(high, f32(0)), last)
    return int(low), int(high), lw, hw


def interpolate(v_lo, v_hi, lw, hw) -> np.float32:
    """The quantile from its two order statistics: ``v_lo lw + v_hi hw``, two
    f32 products and one f32 add (no fused multiply-add)."""
    f32 = np.float32
    return f32(f32(f32(v_lo) * f32(lw)) + f32(f32(v_hi) * f32(hw)))


def tensor_stats_plain(w: torch.Tensor) -> torch.Tensor:
    """(mean, biased std) of one tensor, f32, shape (2,)."""
    w = w.float()
    return torch.stack([w.mean(), w.std(unbiased=False)])


def criterion_plain(w: torch.Tensor, stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``|w|``, or with ``stats`` (mean, std) ``|(w - mean) / std|`` (f32; the
    stats stay 0-dim tensors on w's device, so the division is a true one)."""
    w = w.float()
    if stats is None:
        return w.abs()
    return ((w - stats[0]) / stats[1]).abs()


def magnitude_masks_plain(weights: Sequence[torch.Tensor], pools: Sequence[int], q: float, dist: bool = False,
                          stats: Optional[torch.Tensor] = None):
    """The plain version: each pool's criteria concatenated and sorted
    (``torch.sort``; ``torch.quantile`` refuses more than 2^24 elements), the
    threshold from ``quantile_index`` and ``interpolate``, then the compare.
    ``stats`` (dist only): the (count, 2) per-tensor (mean, std) to use in
    place of this function's own. Returns (masks, thresholds (P,), stats or None)."""
    if dist and stats is None:
        stats = torch.stack([tensor_stats_plain(w) for w in weights])
    crits = [criterion_plain(w, stats[i] if dist else None) for i, w in enumerate(weights)]
    n_pools = max(pools) + 1
    th = np.zeros(n_pools, np.float32)
    for p in range(n_pools):
        pool = torch.cat([c.reshape(-1) for c, pp in zip(crits, pools) if pp == p])
        lo, hi, lw, hw = quantile_index(pool.numel(), q)
        ordered = torch.sort(pool).values
        th[p] = interpolate(ordered[lo].item(), ordered[hi].item(), lw, hw)
    dev = weights[0].device
    th_t = torch.from_numpy(th).to(dev)
    masks = [(c > th_t[p]).float() for c, p in zip(crits, pools)]
    return masks, th_t, stats if dist else None


def _check(weights: Sequence[torch.Tensor], pools: Sequence[int], out: Optional[Sequence[torch.Tensor]]) -> int:
    if not weights or len(pools) != len(weights):
        raise ValueError(f"one pool id per weight; got {len(weights)} weights and {len(pools)} pool ids")
    n_pools = max(pools) + 1
    if min(pools) < 0 or set(pools) != set(range(n_pools)):
        raise ValueError(f"pool ids must cover 0..P-1, got {sorted(set(pools))}")
    for i, w in enumerate(weights):
        check_tensor(w, f"w[{i}]", w.shape, torch.float32)
        if w.numel() == 0:
            raise ValueError(f"w[{i}] is empty")
    if out is not None:
        if len(out) != len(weights):
            raise ValueError(f"one output mask per weight; got {len(out)} for {len(weights)}")
        for i, (m, w) in enumerate(zip(out, weights)):
            check_tensor(m, f"out[{i}]", w.shape, torch.float32)
    check_same_device(*weights, *(out or ()))
    return n_pools


def _tables(weights, masks, pools, q: float, n_pools: int):
    """The kernel's table in host memory, per tensor (w, mask, n, first
    chunk, pool) as 5 int64, and the pools' ranks and weights for the card:
    the select state's first slot, (0, lo) and (0, hi) of each pool, int64
    (4, 2 P, 2), and (lw, hw), f32 (P, 2). Returns (entries, state, lwhw,
    chunks in all)."""
    rows, chunk0 = [], 0
    for w, m, p in zip(weights, masks, pools):
        rows.append(struct.pack("<qqqqq", w.data_ptr(), m.data_ptr(), w.numel(), chunk0, p))
        chunk0 += -(-w.numel() // CHUNK)
    sizes = [0] * n_pools
    for w, p in zip(weights, pools):
        sizes[p] += w.numel()
    state = np.zeros((PASSES + 1, 2 * n_pools, 2), np.int64)
    lwhw = np.zeros((n_pools, 2), np.float32)
    for p, n in enumerate(sizes):
        lo, hi, lw, hw = quantile_index(n, q)
        state[0, 2 * p, 1], state[0, 2 * p + 1, 1] = lo, hi
        lwhw[p] = lw, hw
    # pinned, so that the copies queue on the stream and the host does not wait
    state, lwhw = (torch.from_numpy(a).pin_memory().to(weights[0].device, non_blocking=True) for a in (state, lwhw))
    return ctypes.create_string_buffer(b"".join(rows)), state, lwhw, chunk0


def magnitude_masks(weights: Sequence[torch.Tensor], pools: Sequence[int], q: float, dist: bool = False,
                    out: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[List[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """weights: f32 tensors (any shapes and count, contiguous, one device);
    pools: each tensor's pool id, 0..P-1; q: the sparsity in [0, 1]; out:
    f32 tensors of the weights' shapes to write the masks into (the model's
    mask parameters: written in place, their version counters bumped), or
    None for new ones. Returns (the new f32 0/1 masks, each its weight's
    shape; the pools' thresholds, f32 (P,); with ``dist`` the per-tensor
    (mean, std), f32 (count, 2), else None)."""
    weights = list(weights)
    pools = [int(p) for p in pools]
    n_pools = _check(weights, pools, out)
    if weights[0].device.type == "cpu":
        masks, th, stats = magnitude_masks_plain(weights, pools, q, dist)
        if out is None:
            return masks, th, stats
        for o, m in zip(out, masks):
            o.copy_(m)
        return list(out), th, stats
    masks = [torch.empty_like(w) for w in weights] if out is None else list(out)
    entries, state, lwhw, chunks = _tables(weights, masks, pools, q, n_pools)
    dev = weights[0].device
    hist = torch.zeros(PASSES, 2 * n_pools, BINS, dtype=torch.int32, device=dev)
    th = torch.empty(n_pools, dtype=torch.float32, device=dev)
    stats = torch.empty(len(weights), 2, dtype=torch.float32, device=dev) if dist else None
    partials = torch.empty(chunks, dtype=torch.float32, device=dev) if dist else None
    KERNEL.launch(ctypes.addressof(entries), len(weights), n_pools, chunks, int(dist), _build.ptr(stats),
                  _build.ptr(partials), hist.data_ptr(), state.data_ptr(), lwhw.data_ptr(), th.data_ptr(),
                  _build.stream_handle(weights[0]))
    if out is not None:  # written through the table's pointers: caches keyed on the version see the change
        for m in masks:
            torch.autograd.graph.increment_version(m)
    return masks, th, stats

"""K8: keyed dropout (``csrc/keyed_dropout.cu``).

``keyed_keep_mask`` draws the bool keep-mask of one dropout site and
``keyed_dropout`` applies it (``x / keep_prob`` where kept, 0 elsewhere,
``keep_prob`` rounded to x's dtype as in ``ops/keep.py``; an autograd
Function whose backward applies the same mask to the gradient).
The draw of row n, position j, column c is Philox4x32-10 keyed by the
64-bit ``key`` with counter (site, t0 + j, n, c // 4), word c % 4, kept
where ``(bits >> 8) * 2**-24 < keep_prob``. CUDA tensors launch the kernel,
CPU tensors run the plain version (the same Philox in int64 torch
arithmetic masked to 32 bits, and the same true division, so both agree
bit for bit with each other and with the JAX package's ``x / keep``).
Nothing else falls back, and ``torch.rand``'s own CUDA
Philox is not used: its offsets are not a function of (site, t, row,
column).
"""

from __future__ import annotations

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float
from sparse_caption_tpu_torch.ops.keep import apply_keep, keep_divisor

KERNEL = _build.CudaKernel("keyed_dropout", "sct_keyed_keep_mask", [
    _build.U32, _build.U32, _build.U32, _build.I, _build.I, _build.I, _build.I, _build.F32, _build.P, _build.P,
])
KERNEL_APPLY = _build.CudaKernel("keyed_dropout", "sct_keyed_dropout_apply", [
    _build.I, _build.P, _build.P, _build.U32, _build.U32, _build.U32, _build.I, _build.I, _build.I, _build.I,
    _build.F32, _build.F32, _build.P,
])
M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b, for a < 2^32 and
    int64 b in [0, 2^32), without overflowing int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & M32


def philox4x32_10(c0, c1, c2, c3, key: int):
    """Philox4x32-10 of int64 counter words (each in [0, 2^32), broadcastable)
    under the 64-bit key (low word first). Returns the four int64 words."""
    k0, k1 = key & M32, (key >> 32) & M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & M32, (k1 + PHILOX_W[1]) & M32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keyed_bits(key: int, site: int, t: torch.Tensor, rows: torch.Tensor, cols: int) -> torch.Tensor:
    """The 32-bit draws (int64) of ``cols`` columns at each (t, row) pair of the
    broadcast int64 tensors ``t`` and ``rows``: shape broadcast + (cols,)."""
    t, rows = torch.broadcast_tensors(t, rows)
    c4 = torch.arange((cols + 3) // 4, device=rows.device)
    words = philox4x32_10(torch.full_like(c4, site), t[..., None], rows[..., None], c4, key)
    return torch.stack(torch.broadcast_tensors(*words), dim=-1).flatten(-2)[..., :cols]


def keep_from_bits(bits: torch.Tensor, keep_prob: float) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * 2.0 ** -24 < torch.tensor(keep_prob, dtype=torch.float32)


def keyed_keep_mask_plain(key: int, site: int, t0: int, n: int, tl: int, d: int, keep_prob: float, device):
    t = torch.arange(t0, t0 + tl, device=device)[None, :]
    rows = torch.arange(n, device=device)[:, None]
    return keep_from_bits(keyed_bits(key, site, t, rows, d), keep_prob)


def _check_args(key: int, site: int, t0: int, keep_prob: float) -> None:
    if not 0 <= key < 2 ** 64 or not 0 <= site < 2 ** 32 or not 0 <= t0 < 2 ** 31:
        raise ValueError(f"key, site or t0 out of range: {key}, {site}, {t0}")
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob must be in (0, 1], got {keep_prob}")


def keyed_keep_mask(key: int, site: int, t0: int, n: int, tl: int, d: int, keep_prob: float, device):
    """(n, tl, d) bool keep-mask of ``site``: row r, position j drawn at t0 + j."""
    _check_args(key, site, t0, keep_prob)
    device = torch.device(device)
    if device.type == "cpu":
        return keyed_keep_mask_plain(key, site, t0, n, tl, d, keep_prob, device)
    keep = torch.empty((n, tl, d), dtype=torch.bool, device=device)
    KERNEL.launch(key & M32, key >> 32, site, t0, n, tl, d, keep_prob, keep.data_ptr(), _build.stream_handle(keep))
    return keep


def keyed_dropout_plain(x, key: int, site: int, t0: int, keep_prob: float):
    n, tl, d = x.shape
    return apply_keep(x, keyed_keep_mask_plain(key, site, t0, n, tl, d, keep_prob, x.device), keep_prob)


def _launch_apply(x, key: int, site: int, t0: int, keep_prob: float):
    n, tl, d = x.shape
    out = torch.empty_like(x)
    KERNEL_APPLY.launch(_build.dtype_code(x), x.data_ptr(), out.data_ptr(), key & M32, key >> 32, site, t0, n, tl,
                        d, keep_prob, keep_divisor(keep_prob, x.dtype), _build.stream_handle(x))
    return out


class _KeyedDropoutFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key: int, site: int, t0: int, keep_prob: float):
        ctx.args = (key, site, t0, keep_prob)
        return _launch_apply(x, key, site, t0, keep_prob)

    @staticmethod
    def backward(ctx, g):
        return _launch_apply(g.contiguous(), *ctx.args), None, None, None, None


def keyed_dropout(x, key: int, site: int, t0: int, keep_prob: float):
    """x: (N, T, D) f32 or bf16, contiguous. Returns x / keep_prob where the
    keyed keep-mask holds, 0 elsewhere, in x's dtype."""
    check_float(x, "x")
    if x.dim() != 3:
        raise ValueError(f"x: expected (N, T, D), got {tuple(x.shape)}")
    _check_args(key, site, t0, keep_prob)
    if x.device.type == "cpu":
        return keyed_dropout_plain(x, key, site, t0, keep_prob)
    return _KeyedDropoutFn.apply(x, key, site, t0, float(keep_prob))

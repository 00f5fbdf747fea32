"""K5: supermask weight sample and straight-through backward (``csrc/supermask.cu``).

``supermask_weights(ws, ms, us, mode, bypass)`` returns ``[w * s]``, each in
its w's dtype, with ``s`` the 0/1 sample of the mask logits ``m`` (``MODES``),
for a set of masked tensors: one forward launch and one backward launch over
the whole set (an autograd Function). In mode ``sample`` the forward keeps
the sample as one bit per weight for the backward, which never reads the
uniforms ``u``. ``supermask_weight(w, m, u, mode, bypass)`` is a set of one.
For CPU tensors ``supermask_weight_plain`` runs per tensor, whose autograd
gives the same gradients. Nothing else falls back.

Mode ``keyed`` (supermask SCST: the draws of a decode step must be
reproduced by its gradient pass) is mode ``sample`` with each tensor's
uniforms a pure function of a ``KeyedDraw`` (key, site, t) in place of a
tensor: element e of the weight (its index in the port's (out, in) layout)
draws Philox4x32-10 under the 64-bit key with counter (site, t, e // 4, 0),
word e % 4, and ``u`` is its top 24 bits times 2**-24. The kernel makes
``u`` in registers and never writes it; the plain version
(``keyed_uniform_plain``, the Philox of ``keyed_dropout.philox4x32_10`` in
int64 arithmetic) makes the same ``u`` as a tensor, so the two agree bit for
bit. Its launches count on ``KERNEL_KEYED``.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Optional, Sequence

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor
from sparse_caption_tpu_torch.kernels.keyed_dropout import M32, philox4x32_10
from sparse_caption_tpu_torch.ops.ste import bernoulli_sample_sigmoid, rounding_sigmoid

FWD_ARGS = [_build.I, _build.P, _build.I, _build.I64, _build.P, _build.I, _build.P]
KERNEL = _build.CudaKernel("supermask", "sct_supermask", FWD_ARGS)
# the keyed mode's launches (the same entry point, counted apart)
KERNEL_KEYED = _build.CudaKernel("supermask", "sct_supermask", FWD_ARGS)
KERNEL_BWD = _build.CudaKernel("supermask", "sct_supermask_bwd", [
    _build.I, _build.P, _build.I, _build.I64, _build.P, _build.I, _build.I, _build.P,
])
# sample: [u < sigmoid(m)] (training); round: round(sigmoid(m)) (eval);
# multiply: m itself (the 0/1 masks of the magnitude / lottery / SNIP types);
# keyed: [u < sigmoid(m)] with u from a KeyedDraw (supermask SCST)
MODES = {"sample": 0, "round": 1, "multiply": 2, "keyed": 3}
UNIT = 8  # weights a kernel thread takes at a time; one byte of sample bits
MAX_SET = 128  # tensors of a set: the kernel's table is its parameter (csrc/supermask.cu kMaxEntries)


class KeyedDraw(NamedTuple):
    """The uniforms of one keyed supermask sample: a pure function of the
    stream's 64-bit key, the layer's 32-bit site and the step t."""

    key: int
    site: int
    t: int

    def uniform(self, shape, device) -> torch.Tensor:
        """The f32 uniforms as a tensor of ``shape`` (the plain version)."""
        return keyed_uniform_plain(self, math.prod(int(s) for s in shape), device).reshape(tuple(shape))


def keyed_uniform_plain(draw: KeyedDraw, n: int, device) -> torch.Tensor:
    """The (n,) f32 uniforms of elements 0..n-1 under ``draw``: Philox4x32-10
    with counter (site, t, e // 4, 0), word e % 4, top 24 bits x 2**-24."""
    c = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    words = philox4x32_10(torch.full_like(c, draw.site), torch.full_like(c, draw.t), c, torch.zeros_like(c),
                          draw.key)
    bits = torch.stack(words, dim=-1).flatten()[:n]
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def check_draw(draw: KeyedDraw) -> None:
    if not isinstance(draw, KeyedDraw):
        raise TypeError(f"mode 'keyed' takes a KeyedDraw per weight, got {type(draw).__name__}")
    if not 0 <= draw.key < 2 ** 64 or not 0 <= draw.site <= M32 or not 0 <= draw.t < 2 ** 31:
        raise ValueError(f"key, site or t out of range: {draw}")


def supermask_weight_plain(w, m, u: Optional[torch.Tensor] = None, mode: str = "sample", bypass: bool = False):
    """``(w * sample(m)).to(w.dtype)`` through the straight-through estimators
    of ``ops/ste.py`` (the JAX package's ``_masked``); in mode ``keyed`` u is
    the weight's ``KeyedDraw``."""
    if mode == "keyed":
        mode, u = "sample", u.uniform(w.shape, w.device)
    if mode == "sample":
        s = bernoulli_sample_sigmoid(m, u, bypass)
    elif mode == "round":
        s = rounding_sigmoid(m, bypass)
    else:
        s = m
    return (w * s).to(w.dtype)


def unit_offsets(sizes: Sequence[int]) -> List[int]:
    """Each tensor's first unit of 8 weights in a set of tensors of `sizes`
    weights, and the units of the whole set last."""
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // UNIT))
    return offsets


def _table(rows):
    """The kernel's entries (8 int64 each: 5 pointers, n, unit0, bit0) in host
    memory; the launch passes them by value."""
    flat = [x for row in rows for x in row]
    return (ctypes.c_longlong * len(flat))(*flat)


def _signed64(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _u_words(u) -> tuple:
    """An entry's words 2 and 4: the uniforms' pointer (mode 0), or a keyed
    draw's site | t << 32 and key (mode 3), or nothing."""
    if u is None:
        return 0, 0
    if isinstance(u, KeyedDraw):
        return u.site | (u.t << 32), _signed64(u.key)
    return u.data_ptr(), 0


def launch_forward(ws, ms, us, mode: int):
    """One forward launch over a set of CUDA tensors (checked by the caller):
    (w_effs, the sample bits (int32 words; modes 0 and 3, else None)).
    ``us``: uniform tensors (mode 0) or ``KeyedDraw``s (mode 3)."""
    outs = [torch.empty_like(w) for w in ws]
    offsets = unit_offsets([w.numel() for w in ws])
    units = offsets[-1]
    sampled = mode in (MODES["sample"], MODES["keyed"])
    bits = torch.empty(-(-units // 4), dtype=torch.int32, device=ws[0].device) if sampled else None
    rows = []
    for i, (w, m, out) in enumerate(zip(ws, ms, outs)):
        u2, u4 = _u_words(None if us is None else us[i])
        rows.append([w.data_ptr(), m.data_ptr(), u2, out.data_ptr(), u4, w.numel(), offsets[i], offsets[i]])
    table = _table(rows)
    kernel = KERNEL_KEYED if mode == MODES["keyed"] else KERNEL
    kernel.launch(_build.dtype_code(ws[0]), ctypes.addressof(table), len(rows), units, _build.ptr(bits), mode,
                  _build.stream_handle(ws[0]))
    return outs, bits


def launch_backward(gs, ws, ms, bits, bit_units, mode: int, bypass: bool):
    """One backward launch over a set (or part of one): (dws, dms).
    ``bit_units``: each tensor's first unit in the forward's set (its sample
    bits). The keyed mode's backward is the sample mode's: it reads the bits."""
    mode = MODES["sample"] if mode == MODES["keyed"] else mode
    gs = [g.contiguous() for g in gs]
    dws, dms = [torch.empty_like(w) for w in ws], [torch.empty_like(m) for m in ms]
    offsets = unit_offsets([w.numel() for w in ws])
    rows = [[g.data_ptr(), w.data_ptr(), m.data_ptr(), dw.data_ptr(), dm.data_ptr(), w.numel(), offsets[i],
             bit_units[i]] for i, (g, w, m, dw, dm) in enumerate(zip(gs, ws, ms, dws, dms))]
    table = _table(rows)
    KERNEL_BWD.launch(_build.dtype_code(ws[0]), ctypes.addressof(table), len(rows), offsets[-1], _build.ptr(bits),
                      mode, int(bypass), _build.stream_handle(ws[0]))
    return dws, dms


class _SupermaskSetFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mode: int, bypass: bool, count: int, draws, *tensors):
        ws, ms = tensors[:count], tensors[count:2 * count]
        outs, bits = launch_forward(ws, ms, draws or tensors[2 * count:] or None, mode)
        ctx.mode, ctx.bypass, ctx.count = mode, bypass, count
        ctx.bit_units = unit_offsets([w.numel() for w in ws])[:-1]
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*ws, *ms, *([] if bits is None else [bits]))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.count
        saved = ctx.saved_tensors
        ws, ms = saved[:n], saved[n:2 * n]
        bits = saved[2 * n] if ctx.mode in (MODES["sample"], MODES["keyed"]) else None
        live = [i for i, g in enumerate(gs) if g is not None]  # an output no loss reached gives no gradient
        dws, dms = [None] * n, [None] * n
        if live:
            dw_live, dm_live = launch_backward([gs[i] for i in live], [ws[i] for i in live], [ms[i] for i in live],
                                               bits, [ctx.bit_units[i] for i in live], ctx.mode, ctx.bypass)
            for i, dw, dm in zip(live, dw_live, dm_live):
                dws[i] = dw if ctx.needs_input_grad[4 + i] else None
                dms[i] = dm if ctx.needs_input_grad[4 + n + i] else None
        return (None, None, None, None, *dws, *dms, *([None] * (len(ctx.needs_input_grad) - 4 - 2 * n)))


def supermask_weights(ws: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
                      us: Optional[Sequence[torch.Tensor]] = None, mode: str = "sample",
                      bypass: bool = False) -> List[torch.Tensor]:
    """A set of masked tensors: ws weights (any shapes), f32 or bf16, one
    dtype; ms their mask logits (or 0/1 masks for ``mode="multiply"``), f32,
    each its w's shape; us uniforms in [0, 1), f32, each its w's shape
    (``mode="sample"``), or a ``KeyedDraw`` each (``mode="keyed"``). Returns
    the w_effs, each in its w's dtype."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
    ws, ms = list(ws), list(ms)
    if not ws or len(ms) != len(ws):
        raise ValueError(f"a set needs one mask per weight; got {len(ws)} weights and {len(ms)} masks")
    if len(ws) > MAX_SET:
        raise ValueError(f"a set takes at most {MAX_SET} tensors, got {len(ws)}")
    if mode in ("sample", "keyed"):
        if us is None or len(us) != len(ws):
            raise ValueError(f"mode {mode!r} needs one {'tensor of uniforms u' if mode == 'sample' else 'KeyedDraw'} "
                             f"per weight")
        us = list(us)
        if mode == "keyed":
            for draw in us:
                check_draw(draw)
    elif us is not None:
        raise ValueError(f"mode {mode!r} takes no uniforms")
    for i, (w, m) in enumerate(zip(ws, ms)):
        check_float(w, f"w[{i}]")
        if w.dtype != ws[0].dtype:
            raise TypeError(f"a set takes one dtype; w[0] is {ws[0].dtype}, w[{i}] {w.dtype}")
        check_tensor(m, f"m[{i}]", w.shape, torch.float32)
        if mode == "sample":
            check_tensor(us[i], f"u[{i}]", w.shape, torch.float32)
    check_same_device(*ws, *ms, *(us if mode == "sample" else ()))
    if ws[0].device.type == "cpu":
        return [supermask_weight_plain(w, m, None if us is None else us[i], mode, bypass)
                for i, (w, m) in enumerate(zip(ws, ms))]
    draws = tuple(us) if mode == "keyed" else None
    tensors = us if mode == "sample" else ()
    return list(_SupermaskSetFn.apply(MODES[mode], bypass, len(ws), draws, *ws, *ms, *tensors))


def supermask_weight(w, m, u: Optional[torch.Tensor] = None, mode: str = "sample", bypass: bool = False):
    """One masked tensor (a set of one, ``supermask_weights``): w: weight (any
    shape) f32 or bf16; m: mask logits (or a 0/1 mask for ``mode="multiply"``),
    f32, w's shape; u: uniforms in [0, 1), f32, w's shape (``mode="sample"``),
    or a ``KeyedDraw`` (``mode="keyed"``). Returns w_eff in w's dtype."""
    return supermask_weights([w], [m], None if u is None else [u], mode, bypass)[0]

"""K11: the LSTM cell's gate nonlinearities, forward and backward (``csrc/lstm_cell.cu``).

``lstm_cell(gx, gh, c)`` takes the two gate pre-activations ``gx = x W_ih^T +
b_ih`` and ``gh = h W_hh^T + b_hh`` (N, 4H), in torch gate order (i, f, g,
o), and the cell state c (N, H); it returns ``(h', c')``. CUDA tensors
launch the kernel in both directions (an autograd Function whose backward
recomputes the gates from its saved inputs); CPU tensors run
``lstm_cell_plain``. Nothing else falls back.
"""

from __future__ import annotations

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor

KERNEL = _build.CudaKernel("lstm_cell", "sct_lstm_cell", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.P,
])
KERNEL_BWD = _build.CudaKernel("lstm_cell", "sct_lstm_cell_bwd", [
    _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.P,
])


def lstm_cell_plain(gx, gh, c):
    """``MaskedLSTMCell`` of the JAX package after its two dots."""
    i, f, g, o = (gx + gh).chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


class _LSTMCellFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, gh, c):
        n, h = c.shape
        h_out, c_out = torch.empty_like(c), torch.empty_like(c)
        KERNEL.launch(_build.dtype_code(c), gx.data_ptr(), gh.data_ptr(), c.data_ptr(), h_out.data_ptr(),
                      c_out.data_ptr(), n, h, _build.stream_handle(c))
        ctx.save_for_backward(gx, gh, c)
        ctx.set_materialize_grads(False)
        return h_out, c_out

    @staticmethod
    def backward(ctx, dh, dc):
        gx, gh, c = ctx.saved_tensors
        if dh is None and dc is None:
            return None, None, None
        n, h = c.shape
        dh = None if dh is None else dh.contiguous()
        dc = None if dc is None else dc.contiguous()
        dgates, dc_prev = torch.empty_like(gx), torch.empty_like(c)
        KERNEL_BWD.launch(_build.dtype_code(c), gx.data_ptr(), gh.data_ptr(), c.data_ptr(), _build.ptr(dh),
                          _build.ptr(dc), dgates.data_ptr(), dc_prev.data_ptr(), n, h, _build.stream_handle(c))
        return dgates, dgates, dc_prev


def lstm_cell(gx, gh, c):
    """gx, gh: (N, 4H); c: (N, H); one dtype, f32 or bf16. Returns (h', c'), each (N, H)."""
    check_float(c, "c")
    n, h = c.shape
    check_tensor(gx, "gx", (n, 4 * h), c.dtype)
    check_tensor(gh, "gh", (n, 4 * h), c.dtype)
    check_same_device(gx, gh, c)
    if c.device.type == "cpu":
        return lstm_cell_plain(gx, gh, c)
    return _LSTMCellFn.apply(gx, gh, c)

"""K9: one sampling-decode step (``csrc/sample_step.cu``).

``sample_step`` turns one step's logits into the next tokens: log_softmax,
the previous-token ban, temperature, a Gumbel-max sample keyed by
(key, site, t, row, column) (or the greedy argmax), the chosen log-prob from
the un-tempered log-probs, and the ``unfinished`` latch. It writes column t
of ``seq`` / ``seq_lp`` and updates ``unfinished`` IN PLACE (the JAX package
carries them through its loop). CUDA tensors launch the kernel; CPU tensors
run ``sample_step_plain``, which alone accepts explicit Gumbel noise (the CPU
tests feed the JAX package's draws through it). Nothing else falls back.
"""

from __future__ import annotations

from typing import Optional

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor
from sparse_caption_tpu_torch.kernels.keyed_dropout import M32, keyed_bits

KERNEL = _build.CudaKernel("sample_step", "sct_sample_step", [
    _build.I, _build.P, _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
    _build.U32, _build.U32, _build.U32, _build.I, _build.F32, _build.I, _build.I, _build.I, _build.P,
])
BAN_PREV = -1e30  # decoding/sample.py: nan_to_num(one_hot * -inf, neginf=-1e30)


def gumbel_noise(key: int, site: int, t: int, n: int, vocab: int, device) -> torch.Tensor:
    """(n, vocab) f32 ``-log(-log(u))``, ``u = ((bits >> 9) * 2 + 1) * 2**-24``
    from the keyed Philox bits at (site, t, row, column)."""
    bits = keyed_bits(key, site, torch.full((1,), t, device=device), torch.arange(n, device=device), vocab)
    u = ((bits >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample_logprobs(logits, prev, ban_prev: bool):
    """f32 log-probs rounded through the logits' dtype, with the previous
    token of each row knocked down by 1e30 when ``ban_prev``."""
    c = torch.log_softmax(logits, dim=-1).float()
    if ban_prev:
        c[torch.arange(c.shape[0], device=c.device), prev.long()] += BAN_PREV
    return c


def sample_step_plain(logits, prev, unfinished, seq, seq_lp, t: int, key: int = 0, site: int = 0,
                      greedy: bool = False, temperature: float = 1.0, ban_prev: bool = False, eos_id: int = 3,
                      pad_id: int = 0, noise: Optional[torch.Tensor] = None):
    c = sample_logprobs(logits, prev, ban_prev)
    if greedy:
        z = c
    else:
        if noise is None:
            noise = gumbel_noise(key, site, t, c.shape[0], c.shape[1], c.device)
        z = c / temperature + noise
    w = torch.argmax(z, dim=-1)  # first maximal index
    tok = torch.where(unfinished, w, torch.full_like(w, pad_id)).to(torch.int32)
    seq[:, t] = tok
    seq_lp[:, t] = c.gather(1, w[:, None])[:, 0]
    unfinished &= w != eos_id
    return tok


def sample_step(logits, prev, unfinished, seq, seq_lp, t: int, key: int = 0, site: int = 0, greedy: bool = False,
                temperature: float = 1.0, ban_prev: bool = False, eos_id: int = 3, pad_id: int = 0,
                noise: Optional[torch.Tensor] = None):
    """logits: (N, V) f32 or bf16; prev: (N,) int32, the tokens fed at this
    step (banned when ``ban_prev``); unfinished: (N,) bool, updated in place;
    seq: (N, T_max) int32 and seq_lp: (N, T_max) f32, column t written;
    key, site: the sampling stream (a 64-bit key and a 32-bit site id).
    Returns the next tokens (N,) int32 (pad after a row's EOS)."""
    check_float(logits, "logits")
    n, vocab = logits.shape
    t_max = seq.shape[1]
    check_tensor(prev, "prev", (n,), torch.int32)
    check_tensor(unfinished, "unfinished", (n,), torch.bool)
    check_tensor(seq, "seq", (n, t_max), torch.int32)
    check_tensor(seq_lp, "seq_lp", (n, t_max), torch.float32)
    check_same_device(logits, prev, unfinished, seq, seq_lp, noise)
    if not 0 <= t < t_max:
        raise ValueError(f"t={t} outside the {t_max} columns of seq")
    if not temperature > 0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if not 0 <= key < 2 ** 64 or not 0 <= site < 2 ** 32:
        raise ValueError(f"key or site out of range: {key}, {site}")
    if logits.device.type == "cpu":
        return sample_step_plain(logits, prev, unfinished, seq, seq_lp, t, key, site, greedy, temperature, ban_prev,
                                 eos_id, pad_id, noise)
    if noise is not None:
        raise ValueError("explicit noise is taken by the plain version only (CPU tensors)")
    nxt = torch.empty_like(prev)
    KERNEL.launch(_build.dtype_code(logits), logits.data_ptr(), n, vocab, prev.data_ptr(), unfinished.data_ptr(),
                  seq.data_ptr(), seq_lp.data_ptr(), nxt.data_ptr(), t, t_max, key & M32, key >> 32, site, int(greedy),
                  temperature, int(ban_prev), eos_id, pad_id, _build.stream_handle(logits))
    return nxt

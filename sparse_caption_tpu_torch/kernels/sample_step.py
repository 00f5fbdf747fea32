"""K9: one sampling-decode step (``csrc/sample_step.cu``).

``sample_step`` turns one step's logits into the next tokens: log_softmax,
the previous-token ban, then the ``sample_method`` (``random``: temperature
and a Gumbel-max sample; ``top<k>`` / ``top<p>``: temperature, the top-k or
nucleus filter, a Gumbel-max sample over the filtered values; ``gumbel``:
the Gumbel method on the un-tempered log-probs), all keyed by (key, site,
t, row, column) (or the greedy argmax), the chosen log-prob (un-tempered
for ``random`` and ``gumbel``, the filtered value for ``top*``), and the
``unfinished`` latch. It writes column t of ``seq`` / ``seq_lp`` and updates
``unfinished`` IN PLACE (the JAX package carries them through its loop).
CUDA tensors launch the kernel; CPU tensors run ``sample_step_plain``
(``decoding/sample.py``'s ``modified_sample_logits`` / ``sample_next_word``),
which alone accepts explicit noise (the CPU tests feed the JAX package's
draws through it). Nothing else falls back.

``scheduled_sample`` is K9's ``ss`` mode (``sct_scheduled_sample``, its own
launch count): the Up-Down XE forward's scheduled sampling at step t >= 1.
Each row flips a keyed coin against ``ss_prob``; where it comes up, the
step's input token is a categorical draw from step t-1's log-probs (in the
compute dtype: argmax of the log-probs plus Gumbel noise formed in that
dtype, as ``jax.random.categorical``), else the teacher's token. The draws
are an ``SSDraw`` (key, t), keyed Philox as K9's random mode, or on the CPU
explicit (coin uniforms, noise) (``scheduled_sample_plain``; the tests feed
the JAX package's draws through it).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from sparse_caption_tpu_torch.kernels import _build
from sparse_caption_tpu_torch.kernels._checks import check_float, check_same_device, check_tensor
from sparse_caption_tpu_torch.kernels.keyed_dropout import M32, keyed_bits

ARGS = [
    _build.I, _build.P, _build.I, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
    _build.U32, _build.U32, _build.U32, _build.I, _build.F32, _build.I, _build.I, _build.I, _build.I, _build.I,
    _build.F32, _build.P,
]
KERNEL = _build.CudaKernel("sample_step", "sct_sample_step", ARGS)  # random and greedy
# the sample methods' modes: the same entry point, each counted apart
KERNEL_GUMBEL = _build.CudaKernel("sample_step", "sct_sample_step", ARGS)
KERNEL_TOPK = _build.CudaKernel("sample_step", "sct_sample_step", ARGS)
KERNEL_NUCLEUS = _build.CudaKernel("sample_step", "sct_sample_step", ARGS)
# the ss mode (scheduled sampling)
KERNEL_SS = _build.CudaKernel("sample_step", "sct_scheduled_sample", [
    _build.I, _build.P, _build.I, _build.I, _build.P, _build.P, _build.I, _build.U32, _build.U32, _build.U32,
    _build.U32, _build.F32, _build.P,
])
SS_COIN_SITE = 0x55C01A  # the ss mode's sites under its stream's key: the coins and the noise
SS_NOISE_SITE = 0x55A015
BAN_PREV = -1e30  # decoding/sample.py: nan_to_num(one_hot * -inf, neginf=-1e30)
MODES = {"random": 0, "gumbel": 1, "topk": 2, "nucleus": 3}  # csrc/sample_step.cu SampleMode
TOPK_REGISTER = 32  # csrc/sample_step.cu kTopkRegister: the largest k kept in registers; the radix select above
MAX_DYNAMIC_SMEM = 232448 - 8192  # kSampleMaxDynamicSmem: the opt-in block limit less the static arrays' room


def sample_smem(vocab: int, mode: int, top_k: int) -> int:
    """Dynamic shared memory of a K9 launch (``sct_sample_smem``): 4 bytes an
    entry of the row for the nucleus (its p) and for top-k above
    TOPK_REGISTER (the tempered row), else none."""
    held = mode == MODES["nucleus"] or (mode == MODES["topk"] and top_k > TOPK_REGISTER)
    return 4 * vocab if held else 0


NUCLEUS_MAX_VOCAB = MAX_DYNAMIC_SMEM // sample_smem(1, MODES["nucleus"], 0)  # 56,064


def parse_sample_method(method: str) -> Tuple[str, float]:
    """(mode, top) of a ``sample_method``: ``random``, ``gumbel``, ``greedy``,
    ``top<k>`` (k >= 1, the top-k filter) or ``top<p>`` (0 < p < 1, nucleus)."""
    if method in ("random", "gumbel", "greedy"):
        return method, 0.0
    if method.startswith("top"):
        top = float(method[3:])
        if 0 < top < 1:
            return "nucleus", top
        if top >= 1:
            return "topk", float(int(top))
    raise ValueError(f"unknown sample_method `{method}`")


def keyed_uniform(key: int, site: int, t: int, n: int, vocab: int, device) -> torch.Tensor:
    """(n, vocab) f32 ``u = ((bits >> 9) * 2 + 1) * 2**-24`` in (0, 1) from the
    keyed Philox bits at (site, t, row, column)."""
    bits = keyed_bits(key, site, torch.full((1,), t, device=device), torch.arange(n, device=device), vocab)
    return ((bits >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def gumbel_noise(key: int, site: int, t: int, n: int, vocab: int, device) -> torch.Tensor:
    """(n, vocab) f32 ``-log(-log(u))`` of ``keyed_uniform``."""
    return -torch.log(-torch.log(keyed_uniform(key, site, t, n, vocab, device)))


def sample_logprobs(logits, prev, ban_prev: bool):
    """f32 log-probs rounded through the logits' dtype, with the previous
    token of each row knocked down by 1e30 when ``ban_prev``."""
    c = torch.log_softmax(logits, dim=-1).float()
    if ban_prev:
        c[torch.arange(c.shape[0], device=c.device), prev.long()] += BAN_PREV
    return c


def sample_step_plain(logits, prev, unfinished, seq, seq_lp, t: int, key: int = 0, site: int = 0,
                      greedy: bool = False, temperature: float = 1.0, ban_prev: bool = False, eos_id: int = 3,
                      pad_id: int = 0, noise: Optional[torch.Tensor] = None, sample_method: str = "random"):
    from sparse_caption_tpu_torch.decoding.sample import divide_by_temperature, sample_next_word

    c = sample_logprobs(logits, prev, ban_prev)
    if greedy or sample_method == "greedy":
        w, chosen = sample_next_word(c, "greedy", temperature, None)
    else:
        if noise is None:
            draw = keyed_uniform if sample_method == "gumbel" else gumbel_noise
            noise = draw(key, site, t, c.shape[0], c.shape[1], c.device)
        if sample_method == "random":  # the decode loop's own branch: the chosen log-prob un-tempered
            w = torch.argmax(divide_by_temperature(c, temperature) + noise, dim=-1)  # first maximal index
            chosen = c.gather(1, w[:, None])[:, 0]
        else:
            w, chosen = sample_next_word(c, sample_method, temperature, noise)
    tok = torch.where(unfinished, w, torch.full_like(w, pad_id)).to(torch.int32)
    seq[:, t] = tok
    seq_lp[:, t] = chosen
    unfinished &= w != eos_id
    return tok


def sample_step(logits, prev, unfinished, seq, seq_lp, t: int, key: int = 0, site: int = 0, greedy: bool = False,
                temperature: float = 1.0, ban_prev: bool = False, eos_id: int = 3, pad_id: int = 0,
                noise: Optional[torch.Tensor] = None, sample_method: str = "random"):
    """logits: (N, V) f32 or bf16; prev: (N,) int32, the tokens fed at this
    step (banned when ``ban_prev``); unfinished: (N,) bool, updated in place;
    seq: (N, T_max) int32 and seq_lp: (N, T_max) f32, column t written;
    key, site: the sampling stream (a 64-bit key and a 32-bit site id);
    sample_method: ``random``, ``gumbel``, ``top<k>`` or ``top<p>``
    (``parse_sample_method``; ``greedy`` overrides it); noise (CPU only): the
    (N, V) Gumbel noise, or for ``gumbel`` the uniforms u.
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
    mode, top = parse_sample_method(sample_method)
    if mode == "topk" and top > vocab:
        raise ValueError(f"sample_method {sample_method}: k over the vocabulary of {vocab}")
    if logits.device.type == "cpu":
        return sample_step_plain(logits, prev, unfinished, seq, seq_lp, t, key, site, greedy, temperature, ban_prev,
                                 eos_id, pad_id, noise, sample_method)
    if noise is not None:
        raise ValueError("explicit noise is taken by the plain version only (CPU tensors)")
    greedy = greedy or mode == "greedy"
    if not greedy and sample_smem(vocab, MODES.get(mode, 0), int(top)) > MAX_DYNAMIC_SMEM:
        raise ValueError(f"sample_method {sample_method} holds the row in shared memory: at most "
                         f"{NUCLEUS_MAX_VOCAB} entries; V={vocab}")
    nxt = torch.empty_like(prev)
    kernel = KERNEL if greedy else {"gumbel": KERNEL_GUMBEL, "topk": KERNEL_TOPK, "nucleus": KERNEL_NUCLEUS}.get(mode,
                                                                                                               KERNEL)
    kernel.launch(_build.dtype_code(logits), logits.data_ptr(), n, vocab, prev.data_ptr(), unfinished.data_ptr(),
                  seq.data_ptr(), seq_lp.data_ptr(), nxt.data_ptr(), t, t_max, key & M32, key >> 32, site, int(greedy),
                  temperature, int(ban_prev), eos_id, pad_id, MODES.get(mode, 0), int(top) if mode == "topk" else 0,
                  top if mode == "nucleus" else 0.0, _build.stream_handle(logits))
    return nxt


# ------------------------------------------------------ scheduled sampling
class SSDraw(NamedTuple):
    """The keyed draws of scheduled sampling at step ``t`` under ``key``."""

    key: int
    t: int

    def coin_uniform(self, n: int, device) -> torch.Tensor:
        """(n,) f32 ``(bits >> 8) * 2**-24``, word 0 of Philox (SS_COIN_SITE, t, row, 0)."""
        bits = keyed_bits(self.key, SS_COIN_SITE, torch.full((1,), self.t, device=device),
                          torch.arange(n, device=device), 1)[:, 0]
        return (bits >> 8).to(torch.float32) * 2.0 ** -24

    def noise(self, n: int, vocab: int, dtype, device) -> torch.Tensor:
        """(n, vocab) Gumbel noise in ``dtype``: a uniform with the dtype's
        precision (f32 ``((bits >> 9) * 2 + 1) * 2**-24``, bf16 ``((bits >> 25) *
        2 + 1) * 2**-8``, exact in it) at (SS_NOISE_SITE, t, row, column), then
        ``-log(-log(u))`` with each log rounded to the dtype."""
        bits = keyed_bits(self.key, SS_NOISE_SITE, torch.full((1,), self.t, device=device),
                          torch.arange(n, device=device), vocab)
        if dtype == torch.bfloat16:
            u = (((bits >> 25) * 2 + 1).to(torch.float32) * 2.0 ** -8).to(dtype)
        else:
            u = ((bits >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24
        return -torch.log(-torch.log(u))


SSDraws = Union[SSDraw, Tuple[torch.Tensor, torch.Tensor]]


def scheduled_sample_plain(prev_lp, teacher, ss_prob: float, draw: SSDraws):
    """The plain version: ``draw`` an ``SSDraw`` or explicit (coin uniforms
    (N,) f32, noise (N, V) in prev_lp's dtype). ``argmax(noise + prev_lp)``
    in the log-probs' dtype (the first maximal index), where ``u < ss_prob``."""
    n, vocab = prev_lp.shape
    if isinstance(draw, SSDraw):
        coin_u, noise = draw.coin_uniform(n, prev_lp.device), draw.noise(n, vocab, prev_lp.dtype, prev_lp.device)
    else:
        coin_u, noise = draw
    coin = coin_u < torch.tensor(ss_prob, dtype=torch.float32)
    sampled = torch.argmax(noise.to(prev_lp.dtype) + prev_lp, dim=-1)
    return torch.where(coin, sampled.to(teacher.dtype), teacher)


def scheduled_sample(prev_lp, teacher, ss_prob: float, draw: SSDraws):
    """prev_lp: (N, V) f32 or bf16, step t-1's log-probs (no gradient flows:
    the draw is JAX's stop-gradient sample); teacher: (N,) int, step t's
    teacher tokens; draw: an ``SSDraw``, or (CPU only) explicit draws.
    Returns step t's input tokens (N,) in teacher's dtype."""
    check_float(prev_lp, "prev_lp")
    n, vocab = prev_lp.shape
    check_tensor(teacher, "teacher", (n,), teacher.dtype)
    check_same_device(prev_lp, teacher)
    if not 0.0 <= ss_prob <= 1.0:
        raise ValueError(f"ss_prob must be in [0, 1], got {ss_prob}")
    prev_lp = prev_lp.detach()
    if prev_lp.device.type == "cpu":
        return scheduled_sample_plain(prev_lp, teacher, ss_prob, draw)
    if not isinstance(draw, SSDraw):
        raise ValueError("explicit draws are taken by the plain version only (CPU tensors)")
    if not 0 <= draw.key < 2 ** 64 or not 0 <= draw.t < 2 ** 31:
        raise ValueError(f"key or t out of range: {draw.key}, {draw.t}")
    prev_lp = prev_lp.contiguous()
    teacher_i = teacher.to(torch.int32).contiguous()
    out = torch.empty_like(teacher_i)
    KERNEL_SS.launch(_build.dtype_code(prev_lp), prev_lp.data_ptr(), n, vocab, teacher_i.data_ptr(), out.data_ptr(),
                     draw.t, draw.key & M32, draw.key >> 32, SS_COIN_SITE, SS_NOISE_SITE, ss_prob,
                     _build.stream_handle(prev_lp))
    return out.to(teacher.dtype)

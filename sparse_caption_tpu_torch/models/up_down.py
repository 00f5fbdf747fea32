"""Up-Down (Bottom-Up Top-Down) LSTM captioner (port of
``sparse_caption_tpu/models/up_down.py``).

* token embed -> ReLU -> dropout; fc / att feature projections (ReLU +
  dropout); ``p_att = ctx2att(att)`` computed once per encode
* two LSTM cells per step: the attention LSTM reads ``[h_lang, fc, x_t]``;
  additive attention over the regions with masked renormalisation (softmax
  over every region, then mask and renormalise); the language LSTM reads
  ``[attended, h_att]``; dropout, then the logit layers: ``logit_layers - 1``
  masked (rnn -> rnn) layers, each followed by ReLU and dropout, then (rnn
  -> V)
* the cells keep torch gate order (i, f, g, o) and their two masked
  projections ``ih`` / ``hh`` as GEMMs; the gate nonlinearities run in
  kernel K11, the attention after ``h2att`` in K12, the teacher-forced
  log-softmax over the vocabulary in K13 (once per forward, over the stacked
  steps, in the compute dtype), masked weights in training in K5, drawn
  fresh on every call as the JAX package's flax modules draw them
* memory stays one row per image: the B * rows state rows of a decode (beams)
  or an XE step (captions) read their image's ``att`` / ``p_att`` in K12; the
  ``fc`` projection is repeated to the rows once

The decode cache is the four (N, rnn) LSTM states, which beam search
reorders by parent beam each step (no ancestor map), plus a ``"static"``
subtree it leaves alone. A train-mode decode step (the SCST sampling policy)
draws its dropout from the decode's ``KeyedStream`` at ``t`` and returns f32
logits; ``decode_teacher_forced(train=True)`` replays the same unrolled steps
under the same step views, so its log-probs are the sampling decode's. A
train-mode decode step and ``init_cache`` carry gradients where the caller
has them enabled (the beam-sample SCST gradient pass runs the search again;
the search reorders the states with gradients). Each dropout call (``fc``,
``att``, the token embedding, the output and each hidden logit layer's) has
its own site, so keyed draws at one step are independent, as flax's fresh
key per call makes them.

Scheduled sampling (``ss_prob > 0``) runs in the train-mode XE forward only,
as the JAX package's ``use_ss = train and ss_prob > 0``: from step 1 each
row's input token is, where a keyed coin comes up, a categorical draw from
step t-1's log-probs (kernel K9's ss mode), else the teacher's. Those
log-probs come from K13 a step (row-wise, the same bits as one K13 over the
stacked steps), in the compute dtype; the draws from the random source's
``ss_stream``. The decode and ``decode_teacher_forced`` never draw.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from sparse_caption_tpu_torch import resolve_device
from sparse_caption_tpu_torch.kernels.additive_attention import additive_attention
from sparse_caption_tpu_torch.kernels.lstm_cell import lstm_cell
from sparse_caption_tpu_torch.kernels.sample_step import scheduled_sample
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax
from sparse_caption_tpu_torch.models import register_model
from sparse_caption_tpu_torch.models.transformer import train_rng
from sparse_caption_tpu_torch.ops.masked import (
    MaskConfig,
    MaskedEmbedding,
    MaskedLinear,
    assign_mask_sites,
    mask_set,
    masked_call_order,
)
from sparse_caption_tpu_torch.ops.rng import dropout, site_id

STATE = ("h_att", "c_att", "h_lang", "c_lang")
# the keyed dropout site of each of the model's dropout calls: the four of
# every model, then the hidden logit layers' (``logit_site``)
SITES = {name: site_id(f"up_down.{name}") for name in ("fc", "att", "embed", "out")}


def logit_site(i: int) -> str:
    """The ``SITES`` key of hidden logit layer i's dropout (entered on first use)."""
    name = f"logit.{i}"
    SITES.setdefault(name, site_id(f"up_down.{name}"))
    return name


class MaskedLSTMCell(nn.Module):
    """LSTM cell with prunable ``ih`` / ``hh`` projections (kernel K11 after the two GEMMs)."""

    MASKED_CALL_ORDER = ("ih", "hh")

    def __init__(self, input_size: int, hidden_size: int, mask_cfg: Optional[MaskConfig] = None, **factory):
        super().__init__()
        self.ih = MaskedLinear(input_size, 4 * hidden_size, mask_cfg=mask_cfg, **factory)
        self.hh = MaskedLinear(hidden_size, 4 * hidden_size, mask_cfg=mask_cfg, **factory)

    def forward(self, x, h, c, rng=None):
        """x: (N, in); h, c: (N, H). Returns (h', c')."""
        gx = self.ih(x, rng)
        return lstm_cell(gx, self.hh(h, rng), c)


class AdditiveAttention(nn.Module):
    """Soft attention with masked renormalisation; ``h2att`` stays a GEMM, the rest is kernel K12."""

    MASKED_CALL_ORDER = ("h2att", "alpha_net")

    def __init__(self, rnn_size: int, att_hid_size: int, mask_cfg: Optional[MaskConfig] = None, **factory):
        super().__init__()
        self.h2att = MaskedLinear(rnn_size, att_hid_size, mask_cfg=mask_cfg, **factory)
        self.alpha_net = MaskedLinear(att_hid_size, 1, mask_cfg=mask_cfg, **factory)

    def forward(self, h, att, p_att, mask, rng=None):
        """h: (B * rows, rnn); att: (B, R, rnn); p_att: (B, R, att_hid); mask: (B, R) bool."""
        att_h = self.h2att(h, rng)
        w = self.alpha_net.effective_weight(rng).reshape(-1)
        return additive_attention(p_att, att_h, w, self.alpha_net.bias, mask, att)


@register_model("up_down_lstm")
@register_model("up_down_lstm_prune")
class UpDownModel(nn.Module):
    """Up-Down LSTM. Parameters are created on ``device`` (default ``"cuda"``;
    raises without CUDA) in ``dtype`` and initialised like the JAX package
    (xavier-uniform matrices, zero biases) from ``generator``."""

    COLLATE_FIELDS = ("att_feats", "att_masks", "fc_feats")
    # decode_teacher_forced(train=True) runs the decode's own steps under
    # their step views, so it replays a training supermask's per-step draws too
    STEPWISE_REPLAY = True

    def __init__(self, vocab_size: int, rnn_size: int = 1000, input_encoding_size: int = 1000,
                 att_hid_size: int = 512, fc_feat_size: int = 2048, att_feat_size: int = 2048, logit_layers: int = 1,
                 drop_prob_lm: float = 0.5, max_seq_length: int = 18, pad_id: int = 0, bos_id: int = 2,
                 eos_id: int = 3, unk_id: int = 1, ss_prob: float = 0.0, mask_cfg: Optional[MaskConfig] = None,
                 *, device="cuda", dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        if logit_layers < 1:
            raise ValueError(f"logit_layers must be >= 1, got {logit_layers}")
        if not 0.0 <= ss_prob <= 1.0:
            raise ValueError(f"ss_prob must be in [0, 1], got {ss_prob}")
        self.vocab_size, self.rnn_size = vocab_size, rnn_size
        self.ss_prob = float(ss_prob)
        self.drop_prob_lm = drop_prob_lm
        self.max_seq_length = max_seq_length
        self.pad_id, self.bos_id, self.eos_id, self.unk_id = pad_id, bos_id, eos_id, unk_id
        self.mask_cfg = mask_cfg
        factory = dict(device=resolve_device(device), dtype=dtype)
        self.embed = MaskedEmbedding(vocab_size, input_encoding_size, mask_cfg, **factory)
        self.fc_embed = MaskedLinear(fc_feat_size, rnn_size, mask_cfg=mask_cfg, **factory)
        self.att_embed = MaskedLinear(att_feat_size, rnn_size, mask_cfg=mask_cfg, **factory)
        self.ctx2att = MaskedLinear(rnn_size, att_hid_size, mask_cfg=mask_cfg, **factory)
        self.att_lstm = MaskedLSTMCell(2 * rnn_size + input_encoding_size, rnn_size, mask_cfg, **factory)
        self.lang_lstm = MaskedLSTMCell(2 * rnn_size, rnn_size, mask_cfg, **factory)
        self.attention = AdditiveAttention(rnn_size, att_hid_size, mask_cfg, **factory)
        self.logit = nn.ModuleList(
            [MaskedLinear(rnn_size, rnn_size, mask_cfg=mask_cfg, **factory) for _ in range(logit_layers - 1)]
            + [MaskedLinear(rnn_size, vocab_size, mask_cfg=mask_cfg, **factory)])
        self._logit_sites = [logit_site(i) for i in range(logit_layers - 1)]
        # the masked layers of one unrolled step, in call order (one K5 set a step)
        self._step_masked = masked_call_order(self.embed, self.att_lstm, self.attention, self.lang_lstm, *self.logit)
        self.reset_parameters(generator)
        assign_mask_sites(self)
        self.eval()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, (MaskedLinear, MaskedEmbedding)):
                m.reset_parameters(generator)

    def _drop(self, x, rng, site: str):
        return dropout(x, self.drop_prob_lm, rng, SITES[site])

    # ------------------------------------------------------ masked products
    def mask_set(self, rng=None):
        """One K5 set (``ops/masked.py mask_set``) for the encode's masked
        products; each unrolled step draws its own set of 8, as flax samples
        fresh masks on every call."""
        return mask_set(masked_call_order(self.fc_embed, self.att_embed, self.ctx2att), rng)

    # ------------------------------------------------------------- encode
    def encode(self, att_feats, att_masks, fc_feats=None, boxes=None, train: bool = False,
               rng=None) -> Dict[str, Any]:
        """att_feats: (B, R, F); att_masks: (B, R), 0 = padded; fc_feats: (B, F).
        Returns the memory dict {fc, att, p_att, mask (bool)}."""
        del boxes
        if fc_feats is None:
            raise ValueError("up_down_lstm requires fc_feats")
        rng = train_rng(train, rng)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()), self.mask_set(rng):
            fc = self._drop(torch.relu(self.fc_embed(fc_feats, rng)), rng, "fc")  # (B, rnn)
            att = self._drop(torch.relu(self.att_embed(att_feats, rng)), rng, "att")  # (B, R, rnn)
            p_att = self.ctx2att(att, rng)  # (B, R, att_hid)
            return {"fc": fc, "att": att, "p_att": p_att, "mask": (att_masks != 0).contiguous()}

    # --------------------------------------------------------------- core
    def _core_step(self, it, state: Dict[str, torch.Tensor], fc_rows, memory: Dict[str, Any], rng=None):
        """One step over N = B * rows state rows: (logits (N, V), new state).
        ``rng``: a ``TrainRandom``, or a ``KeyedStream``'s step view. The
        step's masked products run as one K5 set."""
        with mask_set(self._step_masked, rng):
            xt = self._drop(torch.relu(self.embed(it, rng)), rng, "embed")
            h_att, c_att = self.att_lstm(torch.cat([state["h_lang"], fc_rows, xt], dim=1), state["h_att"],
                                         state["c_att"], rng)
            att_res = self.attention(h_att, memory["att"], memory["p_att"], memory["mask"], rng)
            h_lang, c_lang = self.lang_lstm(torch.cat([att_res, h_att], dim=1), state["h_lang"], state["c_lang"],
                                            rng)
            x = self._drop(h_lang, rng, "out")
            for layer, site in zip(self.logit[:-1], self._logit_sites):
                x = self._drop(torch.relu(layer(x, rng)), rng, site)
            logits = self.logit[-1](x, rng)
        return logits, {"h_att": h_att, "c_att": c_att, "h_lang": h_lang, "c_lang": c_lang}

    def _unroll(self, memory: Dict[str, Any], seqs, rng, step_views: bool, ss=None):
        """The stacked logits (N, T-1, V) of feeding seqs[:, :-1] from zero
        states; ``step_views``: step t draws from ``rng.at(t)`` (a keyed
        stream replaying a decode), else every step from ``rng`` in call
        order. With ``ss`` (a ``ScheduledSampling`` stream) the stacked
        log-probs instead (K13 a step, the compute dtype), step t >= 1 fed
        by ``scheduled_sample`` on step t-1's."""
        b, n = memory["fc"].shape[0], seqs.shape[0]
        if n % b:
            raise ValueError(f"{n} caption rows for {b} images")
        fc_rows = memory["fc"].repeat_interleave(n // b, dim=0)
        zeros = torch.zeros((n, self.rnn_size), dtype=fc_rows.dtype, device=fc_rows.device)
        state = dict.fromkeys(STATE, zeros)
        outs = []
        for t in range(seqs.shape[1] - 1):
            step_rng = rng.at(t) if step_views and rng is not None else rng
            it = seqs[:, t]
            if ss is not None and t >= 1:
                prev = outs[-1]
                it = scheduled_sample(prev, it.contiguous(), self.ss_prob,
                                      ss.draw(t, n, prev.shape[1], prev.dtype, prev.device))
            step_logits, state = self._core_step(it, state, fc_rows, memory, step_rng)
            outs.append(step_logits if ss is None else vocab_log_softmax(step_logits))
        return torch.stack(outs, dim=1)

    # ------------------------------------------------------------ XE path
    def forward(self, att_feats, att_masks, seqs, fc_feats=None, boxes=None, train: bool = False, rng=None):
        """Teacher-forced log-probs (N, T-1, V) of seqs[:, 1:] in the compute
        dtype; N a multiple of the batch (rows of one image share its memory).
        In train mode with ``ss_prob > 0`` the inputs from step 1 are
        scheduled samples (``rng.ss_stream()``)."""
        rng = train_rng(train, rng)
        with torch.set_grad_enabled(train):
            memory = self.encode(att_feats, att_masks, fc_feats, boxes, train, rng)
            if train and self.ss_prob > 0:
                return self._unroll(memory, seqs, rng, step_views=False, ss=rng.ss_stream())
            return vocab_log_softmax(self._unroll(memory, seqs, rng, step_views=False))

    # --------------------------------------------- SCST teacher-forced replay
    def decode_teacher_forced(self, memory_pytree: Dict[str, Any], seqs, train: bool = False, rng=None):
        """Log-probs (N, T-1, V) of ``seqs[:, 1:]`` given an encoded memory (N
        a multiple of its batch). With ``train=True`` and the ``KeyedStream``
        of a train-mode decode, step t draws from ``rng.at(t)`` as the decode
        did, so the result (f32, as the decode's sampling step computes it)
        equals the decode's per-step log-probs at every position up to its
        EOS; gradients flow unless the caller disabled them (the sampled
        tokens carry none, so this is the gradient of the decode itself)."""
        rng = train_rng(train, rng)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            logits = self._unroll(memory_pytree, seqs, rng, step_views=True)
            return vocab_log_softmax(logits, torch.float32 if train else logits.dtype)

    # ------------------------------------------------------------- decode
    def init_cache(self, memory_pytree: Dict[str, Any], max_steps: Optional[int] = None, rows_per_image: int = 1,
                   beam_ancestry: bool = False, train: bool = False, rng=None) -> Dict[str, Any]:
        """Zero LSTM states at ``B * rows_per_image`` rows and, under
        ``"static"``, the fc projection repeated to those rows. There is no
        per-step history and no cached projection, so ``max_steps``,
        ``beam_ancestry`` and ``rng`` change nothing: beam search reorders the
        state rows themselves. In train mode the fc rows carry the memory's
        gradient where the caller has gradients enabled."""
        del max_steps, beam_ancestry, rng
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            fc_rows = memory_pytree["fc"].repeat_interleave(int(rows_per_image), dim=0)
        zeros = torch.zeros_like(fc_rows)
        return dict(dict.fromkeys(STATE, zeros), static={"fc": fc_rows})

    def decode_step_logits(self, it, cache: Dict[str, Any], t: int, memory_pytree: Dict[str, Any],
                           train: bool = False, rng=None):
        """it: (N,) current tokens. Returns (logits (N, V), cache); in train
        mode (``rng`` the decode's ``KeyedStream``) dropout draws at t, the
        logits are f32, and gradients flow where the caller has them enabled."""
        rng = train_rng(train, rng)
        rng = None if rng is None else rng.at(t)
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            logits, state = self._core_step(it, cache, cache["static"]["fc"], memory_pytree, rng)
        return (logits.float() if train else logits), dict(state, static=cache["static"])

    @torch.no_grad()
    def decode_step(self, it, cache: Dict[str, Any], t: int, memory_pytree: Dict[str, Any], train: bool = False,
                    rng=None):
        """it: (N,) current tokens. Returns (log-probs (N, V), cache)."""
        logits, cache = self.decode_step_logits(it, cache, t, memory_pytree, train, rng)
        return vocab_log_softmax(logits), cache

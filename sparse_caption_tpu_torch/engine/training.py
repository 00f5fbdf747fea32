"""The train steps (port of ``sparse_caption_tpu/engine/training.py``
``make_xe_step`` 489-570, ``make_scst_step`` 675-859, ``_grad_update``
445-455, ``_loss_criterion`` 428-432 and ``_sparsity_loss_args`` 434-443) as
plain functions.

    params, masks = split_params(model)
    opt_w = build_weight_optimizer(params.values(), config, make_schedule(config))
    opt_m = build_mask_optimizer(masks.values(), config, trainable=True)
    step = make_xe_step(model, opt_w, opt_m, config)
    state, loss, aux = step(TrainState(), batch)

``batch`` holds the model's ``COLLATE_FIELDS`` (``att_feats`` (B, R, F),
``att_masks`` (B, R), and ``boxes`` (B, R, 4) for the ORT or ``fc_feats``
(B, F) for Up-Down), ``seqs`` (B * seq_per_img, T) and ``seq_masks``
(B * seq_per_img, T). The model is updated in place; ``TrainState``
carries the update count (the schedule's and the sparsity anneal's step);
after a step each parameter's ``.grad`` holds that step's raw gradient. With ``train_precision`` bf16 the master
params stay f32 and the forward runs on a differentiable bf16 cast of them
(masks and boxes stay f32; the ORT's log-softmax writes f32, Up-Down's the
compute dtype, as the JAX package's do).

SCST (the two-phase step with the device reward, ``scst_reward device``;
supermask, mask_freeze or dense models of either family, ``scst_sample
random``):

    reward_fn = make_reward_fn(DfTable.from_pickle(df_path, tok2id), bleu_weight=(0, 0, 0, 1))
    step = make_scst_step(model, opt_w, opt_m, config, reward_fn)
    batch = dict(att_feats=..., att_masks=..., boxes=...,  # fc_feats=... for Up-Down
                 ref_pack=scst_ref_pack(gts, df, table, tok2id, vocab_size, device))
    state, loss, aux = step(TrainState(), batch)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sparse_caption_tpu_torch.decoding.api import generate
from sparse_caption_tpu_torch.engine import losses as losses_mod
from sparse_caption_tpu_torch.engine.optim import Optimizer
from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, TrainRandom, decode_train_keys, derive_key
from sparse_caption_tpu_torch.pruning.engine import compute_sparsity_loss
from sparse_caption_tpu_torch.scst.device_reward import leave_one_out_baseline


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: int = 0  # updates done so far


def loss_criterion(config):
    ls = float(config.get("label_smoothing", 0.0))
    if ls > 0:
        return functools.partial(losses_mod.label_smoothing_loss, smoothing=ls)
    return losses_mod.language_model_loss


def sparsity_loss_args(mask_cfg: Optional[MaskConfig], config) -> Optional[Tuple[float, float]]:
    """(target, weight) of the supermask sparsity loss, or None without supermasks."""
    if mask_cfg is None or not mask_cfg.is_supermask:
        return None
    target = float(config.get("prune_sparsity_target", 0.8))
    weight = float(config.get("prune_supermask_sparsity_weight", -1.0))
    if weight <= 0:
        # reference default: max(5, C / (1 - s))
        c = 0.5 if "lstm" in str(config.get("caption_model", "")) else 1.5
        weight = max(5.0, c / (1.0 - target))
    return target, weight


def grad_update(state: TrainState, opt_w: Optimizer, opt_m: Optimizer) -> TrainState:
    """One optimizer update of weights and masks from their ``.grad``, then the step bump."""
    opt_w.step(state.step)
    opt_m.step(state.step)
    return TrainState(state.step + 1)


def make_xe_step(model: nn.Module, opt_w: Optimizer, opt_m: Optimizer, config):
    """-> ``xe_step(state, batch, rng=None) -> (state, loss, aux)``; ``rng`` (a
    ``TrainRandom``) defaults to one seeded from ``config["seed"] + 1``."""
    criterion = loss_criterion(config)
    sp_args = sparsity_loss_args(model.mask_cfg, config)
    freeze_scope = [s for s in str(config.get("prune_mask_freeze_scope", "")).split(",") if s]
    max_step = int(config.get("max_train_step", 1))
    bf16 = str(config.get("train_precision", "fp32")) == "bf16"
    params, masks = split_params(model)
    device = next(iter(params.values())).device
    default_rng = TrainRandom(torch.Generator(device=device).manual_seed(int(config.get("seed", 8888)) + 1))

    extra_fields = [k for k in model.COLLATE_FIELDS if k not in ("att_feats", "att_masks")]  # boxes / fc_feats

    def forward(inputs: Dict, rng: TrainRandom):
        args = (inputs["att_feats"], inputs["att_masks"], inputs["seqs"])
        kwargs = dict({k: inputs[k] for k in extra_fields}, train=True, rng=rng)
        if not bf16:
            return model(*args, **kwargs)
        # differentiable cast of the f32 master params; masks stay f32
        cast = {n: p.to(torch.bfloat16) for n, p in params.items() if p.is_floating_point()}
        return torch.func.functional_call(model, cast, args, kwargs)

    def xe_step(state: TrainState, batch: Dict, rng: Optional[TrainRandom] = None):
        rng = rng or default_rng
        opt_w.zero_grad()
        opt_m.zero_grad()
        inputs = dict(batch)
        if bf16:
            # boxes stay f32: the geometry's x100-scaled trig arguments need it
            for k in model.COLLATE_FIELDS:
                if k != "boxes":
                    inputs[k] = inputs[k].to(torch.bfloat16)
        lp = forward(inputs, rng)
        seqs = inputs["seqs"]
        loss = criterion(lp, seqs[:, 1:], inputs["seq_masks"][:, 1:])
        aux = {"caption_loss": loss.detach()}
        if sp_args is not None:
            sp, sp_aux = compute_sparsity_loss(masks, sp_args[0], sp_args[1], state.step, max_step, freeze_scope)
            loss = loss + sp
            aux.update({k: v.detach() for k, v in sp_aux.items()})
        loss.backward()
        return grad_update(state, opt_w, opt_m), loss.detach(), aux

    return xe_step


def scan_log_probs(model: nn.Module, memory: Dict, flat: torch.Tensor, dec_seed: int) -> torch.Tensor:
    """The train-mode sampling decode of ``decoding.generate(...,
    decode_train=True, rng=dec_seed)`` run again, step by step, with
    gradients, feeding it the tokens it sampled (``flat`` (N, T), pad after
    EOS): its cache under the cache stream, step t under the dropout
    stream's step view, so every dropout and supermask draw is the decode's.
    Returns each step's log-prob of its token (N, T), f32, through kernel K13
    (the JAX package's differentiable scan on the same tokens,
    ``engine/training.py:693-703,769``)."""
    keys = decode_train_keys(dec_seed)
    n, steps = flat.shape
    cache = model.init_cache(memory, steps, n // memory["mask"].shape[0], train=True, rng=KeyedStream(keys.cache))
    step_rng = KeyedStream(keys.dropout)
    it = torch.full((n,), model.bos_id, dtype=flat.dtype, device=flat.device)
    out = []
    for t in range(steps):
        logits, cache = model.decode_step_logits(it, cache, t, memory, True, step_rng)
        out.append(torch.gather(vocab_log_softmax(logits), 1, flat[:, t: t + 1].long())[:, 0])
        it = flat[:, t]
    return torch.stack(out, dim=1)


def make_scst_step(model: nn.Module, opt_w: Optimizer, opt_m: Optimizer, config, reward_fn):
    """-> ``scst_step(state, batch) -> (state, loss, aux)``, the two-phase SCST
    step with the device reward (``reward_fn``: ``scst.device_reward.make_reward_fn``).

    ``batch`` holds the model's ``COLLATE_FIELDS`` (``att_feats`` (B, R, F),
    ``att_masks`` (B, R), and ``boxes`` (B, R, 4) for the ORT or ``fc_feats``
    (B, F) for Up-Down) and ``ref_pack``, the batch's reference pack on the
    model's device (``scst.device_reward.scst_ref_pack``). Each step derives
    one seed from ``config["seed"]`` and the update count, and from it the
    encoder's and the decoder's keyed streams:

    1. ``scst_step.sample_fn(state, batch)``, under ``torch.no_grad``: a
       train-mode encode and ``scst_num_samples`` sampled captions per image
       under the train policy (keyed dropout per step), and with
       ``scst_baseline greedy`` an eval-mode greedy caption;
    2. ``scst_step.grad_fn(state, batch, res)``: rewards of the samples (K10)
       minus the baseline (the other samples' mean, or the greedy caption's
       reward), then ONE teacher-forced forward in replay mode under the same
       streams, which reproduces the sampling decode's log-probs (the ORT in
       one parallel pass; Up-Down through its unrolled steps, step t under
       the step view at t, which is the JAX package's differentiable scan
       on the same tokens), the REINFORCE loss, its backward and the
       optimizer update of weights and masks.

    A supermask model draws fresh masks at every decode step (keyed, so the
    gradient pass draws the same ones: ``ops/rng.py``). One parallel pass
    cannot reproduce that, so the ORT's gradient pass re-encodes and runs
    the decode again step by step with gradients (``scan_log_probs``, K2's
    and K3's backward kernels); Up-Down's unrolled replay is that scan
    already (``STEPWISE_REPLAY``).

    ``config["scst_reward"]`` must be ``"device"``: the host reward, the JAX
    package's default when the key is absent, raises ``NotImplementedError``
    until it is ported. Beam-sample SCST and the pipelined and fused steps
    raise ``NotImplementedError`` too."""
    num_samples = int(config.get("scst_num_samples", 15))
    sample_mode = str(config.get("scst_sample", "random"))
    baseline_mode = str(config.get("scst_baseline", "greedy"))
    if sample_mode == "beam_search":
        raise NotImplementedError("beam-sample SCST lands in a later slice")
    if sample_mode != "random" or baseline_mode not in ("greedy", "sample"):
        raise ValueError(f"bad scst_sample `{sample_mode}` or scst_baseline `{baseline_mode}`")
    if str(config.get("scst_reward", "host")) != "device":  # the JAX package's default is the host reward
        raise NotImplementedError("the host reward path and its scorer land in a later slice")
    scan = (model.mask_cfg is not None and model.mask_cfg.is_supermask
            and not getattr(model, "STEPWISE_REPLAY", False))
    max_len = int(config.get("max_seq_length", 18)) - 1
    sample_opt = {"num_random_sample": num_samples, "beam_size": 0, "max_seq_length": max_len,
                  "temperature": float(config.get("scst_temperature", 1.0)), "decode_train": True}
    greedy_opt = {"beam_size": 1, "max_seq_length": max_len}
    base_seed = derive_key(int(config.get("seed", 8888)) + 1, 0x5C57)

    def seeds(state: TrainState):
        """(encoder key, decode seed) of the step."""
        step_seed = derive_key(base_seed, state.step)
        return derive_key(step_seed, 1), derive_key(step_seed, 2)

    def encode(batch: Dict, rng=None):
        """The model's encode on its ``COLLATE_FIELDS``, by name (``boxes`` for
        the ORT, ``fc_feats`` for Up-Down); train mode under ``rng``."""
        fields = {k: batch[k] for k in model.COLLATE_FIELDS}
        return model.encode(**fields, train=rng is not None, rng=rng)

    @torch.no_grad()
    def sample_fn(state: TrainState, batch: Dict) -> Dict:
        enc_key, dec_seed = seeds(state)
        memory = encode(batch, KeyedStream(enc_key))
        out = {"sample": generate(model, memory, sample_opt, rng=dec_seed)[0]}
        if baseline_mode == "greedy":
            out["greedy"] = generate(model, encode(batch), greedy_opt)[0]
        return out

    def grad_fn(state: TrainState, batch: Dict, res: Dict):
        enc_key, dec_seed = seeds(state)
        sample = res["sample"]
        b, s, t = sample.shape
        flat = sample.reshape(b * s, t)
        with torch.no_grad():
            img = torch.arange(b, device=flat.device, dtype=torch.int32)
            sc_s = reward_fn(flat, img.repeat_interleave(s), batch["ref_pack"])
            if baseline_mode == "greedy":
                sc_b = reward_fn(res["greedy"].reshape(b, t), img, batch["ref_pack"]).repeat_interleave(s)
            else:
                sc_b = leave_one_out_baseline(sc_s, s)
            rewards = sc_s - sc_b
        opt_w.zero_grad()
        opt_m.zero_grad()
        enc_rng = KeyedStream(enc_key)
        if scan:  # the decode itself, with gradients: its encode, its cache and its steps
            seq_lp = scan_log_probs(model, encode(batch, enc_rng), flat, dec_seed)
        else:
            with model.mask_set(enc_rng):  # the replay's masked products: one K5 set (ORT), or the encode's (Up-Down)
                memory = encode(batch, enc_rng)
                seqs_in = torch.cat([torch.full((b * s, 1), model.bos_id, dtype=flat.dtype, device=flat.device), flat],
                                    1)
                lp = model.decode_teacher_forced(memory, seqs_in, train=True,
                                                 rng=KeyedStream(decode_train_keys(dec_seed).dropout))
            seq_lp = torch.gather(lp, 2, flat.long()[..., None])[..., 0]
        loss = losses_mod.reward_loss(seq_lp, flat != model.pad_id, rewards)
        loss.backward()
        aux = {"avg_reward": rewards.mean(), "avg_sample": sc_s.mean(), "avg_baseline": sc_b.mean()}
        return grad_update(state, opt_w, opt_m), loss.detach(), aux

    def scst_step(state: TrainState, batch: Dict):
        return grad_fn(state, batch, sample_fn(state, batch))

    scst_step.sample_fn = sample_fn
    scst_step.grad_fn = grad_fn
    return scst_step


def make_scst_pipelined_step(*args, **kwargs):
    raise NotImplementedError("the pipelined SCST step lands in a later slice")


def make_scst_fused_step(*args, **kwargs):
    raise NotImplementedError("the fused SCST step lands in a later slice")

"""Up-Down's sparse SCST slice of the PyTorch port against the JAX package on
the CPU, at small widths (rnn 32, att_hid 16, vocab 40, 5 regions with
padding, 6 steps): greedy and random sampling decode (the JAX side's Gumbel
noise replayed through ``generate(..., noise=...)``), the keyed dropout sites
of the model's four dropout calls, the teacher-forced replay of a train-mode
sampling decode, and one whole two-phase SCST step of a mask_freeze model at
0.991 sparsity against the JAX package's differentiable scan on the same
tokens.

Tolerances: log-probs 1e-5 absolute (f32, summation order only); the whole
step as ``tests/test_torch_port_scst.py`` holds the ORT's: rewards rtol 1e-5 /
atol 1e-6, loss 1e-5 relative, each gradient within 1e-5 of its tensor's
largest entry plus 1e-6 of the largest gradient of all, params after the
Adam update within 1e-7 + 1e-6 |p| (plus 2 lr where the gradient is within
its tolerance of 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparse_caption_tpu.ops.masked as jax_masked
from _torch_port_common import t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.decoding.api import decode_train_keys as jax_decode_train_keys
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.engine import optim as jax_optim
from sparse_caption_tpu.models import up_down as jud
from sparse_caption_tpu.scst import device_reward as devr
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import TrainState, make_scst_step
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.metrics.cider import build_df_pickle, load_df_pickle
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.models import up_down as pud
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, decode_train_keys
from sparse_caption_tpu_torch.scst import device_reward as port_devr
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

V, RNN, HID, FEAT, R, T = 40, 32, 16, 12, 5, 7
L = T - 1
KW = dict(vocab_size=V, rnn_size=RNN, input_encoding_size=RNN, att_hid_size=HID, fc_feat_size=FEAT,
          att_feat_size=FEAT, max_seq_length=L)
LP_TOL = 1e-5
SPARSITY = 0.991  # the paper's Up-Down SCST (resources/commands_pruning.sh:113)
VOCAB = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(4, V)]
TOK2ID = {w: i for i, w in enumerate(VOCAB)}


def make_inputs(seed: int = 0, batch: int = 2):
    """att (B, R, F), att mask (B, R) with image 1's last two regions padded, fc (B, F)."""
    rng = np.random.default_rng(seed)
    att = rng.normal(size=(batch, R, FEAT)).astype(np.float32)
    fc = rng.normal(size=(batch, FEAT)).astype(np.float32)
    amask = np.ones((batch, R), np.float32)
    amask[1, R - 2:] = 0.0
    return att, amask, fc


def _mask_freeze(drop: float = 0.0, sparsity: float = 0.5, seed: int = 21):
    """JAX Up-Down with frozen 0/1 masks (kept where a uniform >= the
    sparsity, as bench.py:340-344 draws them), its variables, and the port
    model with the masks kept unfolded. The init's weights are scaled by 3
    and its biases drawn N(0, 0.2), with the EOS logit lowered by 2, so that
    captions are not one token repeated and do not end at once."""
    att, amask, fc = make_inputs()
    jm = jud.UpDownModel(**KW, drop_prob_lm=drop, mask_cfg=jax_masked.MaskConfig("mask_freeze", 1.0))
    seqs = np.full((2, T), 4, np.int32)
    variables = to_numpy(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(att), jnp.asarray(amask),
                                 jnp.asarray(seqs), fc_feats=jnp.asarray(fc)))
    rng = np.random.default_rng(seed)
    variables["masks"] = jax.tree.map(lambda m: (rng.uniform(size=m.shape) >= sparsity).astype(np.float32),
                                      variables["masks"])
    variables["params"] = jax.tree_util.tree_map_with_path(
        lambda path, p: (p + rng.normal(0, 0.2, size=p.shape) if path[-1].key == "bias" else 3 * p).astype(np.float32),
        variables["params"])
    variables["params"]["logit_0"]["bias"][3] -= 2.0
    port = get_model("up_down_lstm_prune")(**KW, drop_prob_lm=drop, device="cpu",
                                           mask_cfg=MaskConfig("mask_freeze", keep_masks=True))
    return jm, variables, load_jax_variables(port, variables)


def _jax_encode(jm, variables, train=False):
    att, amask, fc = (jnp.asarray(a) for a in make_inputs())
    key = jax.random.PRNGKey(1)
    return jm.apply(variables, att, amask, fc_feats=fc, train=train, rngs={"dropout": key, "mask": key},
                    method="encode")


def _port_encode(port, **kw):
    att, amask, fc = make_inputs()
    return port.encode(t(att), t(amask), t(fc), **kw)


# --------------------------------------------------------- sampling decode
@pytest.mark.parametrize("mode,constraint", [("greedy", 0), ("greedy", 1), ("random", 0), ("random", 1)])
def test_sample_decode_matches_jax(mode, constraint):
    """Greedy and random sampling (temperature 0.7 under the train policy,
    JAX's Gumbel noise replayed) of a mask_freeze Up-Down: identical tokens,
    chosen log-probs within 1e-5 at non-pad positions. The JAX side repeats
    the memory per sample; the port reads one row per image."""
    jm, variables, port = _mask_freeze()
    memory = _jax_encode(jm, variables)
    if mode == "greedy":
        rows, noise = 1, None
        opt = {"beam_size": 1, "max_seq_length": L, "decoding_constraint": constraint}
        ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt))
    else:
        rows = 3
        opt = {"num_random_sample": rows, "beam_size": 0, "max_seq_length": L, "temperature": 0.7,
               "decoding_constraint": constraint, "decode_train": True}
        key = jax.random.PRNGKey(31)
        ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt, rng=key))
        k, g = jax_decode_train_keys(key)[0], []  # sample_decode's step keys
        for _ in range(L):
            k, sub = jax.random.split(k)
            g.append(np.asarray(jax.random.gumbel(sub, (2 * rows, V))))
        noise = lambda step: t(g[step])  # noqa: E731
    before = launch_counts()
    seq, lp = generate(port, _port_encode(port), opt, rng=5, noise=noise)
    assert launch_counts() == before  # CPU tensors take the plain versions
    assert seq.shape == (2, rows, L)
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    valid = ref_seq != 0
    assert valid.any() and len(np.unique(ref_seq)) > 3
    np.testing.assert_allclose(lp.numpy()[valid], ref_lp[valid], rtol=0, atol=LP_TOL)


# ------------------------------------------------------------ dropout sites
def test_dropout_calls_draw_from_distinct_sites(monkeypatch):
    """Under one ``KeyedStream`` the encode's ``fc`` and ``att`` dropout and a
    decode step's embedding and output dropout draw independent keep-masks
    (flax draws a fresh key per call). With one shared site, ``fc``'s mask
    equalled ``att``'s region-0 mask and the embedding's the output's."""
    _, _, port = _mask_freeze(drop=0.5)
    kept = []
    real = pud.dropout

    def recording(x, rate, rng, site=None):
        kept.append(real(torch.ones_like(x), rate, rng, site) != 0)
        return real(x, rate, rng, site)

    monkeypatch.setattr(pud, "dropout", recording)
    stream = KeyedStream(0x5EED)
    with torch.no_grad():
        memory = _port_encode(port, train=True, rng=stream)
        fc, att = kept
        assert fc.shape == att[:, 0].shape and not torch.equal(fc, att[:, 0])
        cache = port.init_cache(memory, L, 2, train=True, rng=stream)
        port.decode_step_logits(torch.full((4,), 2, dtype=torch.int32), cache, 3, memory, True, stream)
    embed, out = kept[2:]
    assert embed.shape == out.shape == (4, RNN) and not torch.equal(embed, out)
    assert len(set(pud.SITES.values())) == 4


# ------------------------------------------------------------------ replay
def test_replay_equals_sampling_with_dropout():
    """With dropout 0.5, one teacher-forced replay of the unrolled steps
    under the decode's keyed stream (step t under its view at t) gives the
    train-mode sampling decode's log-probs at every non-pad position; another
    stream does not."""
    _, _, port = _mask_freeze(drop=0.5)
    rows, seed = 3, 99
    opt = {"num_random_sample": rows, "beam_size": 0, "max_seq_length": L, "decode_train": True}
    with torch.no_grad():
        memory = _port_encode(port, train=True, rng=KeyedStream(8))
        seq, seq_lp = generate(port, memory, opt, rng=seed)
        flat = seq.reshape(-1, L).long()
        seqs_in = torch.cat([torch.full((flat.shape[0], 1), port.bos_id), flat], 1)

        def replay(key):
            lp = port.decode_teacher_forced(memory, seqs_in, train=True, rng=KeyedStream(key))
            assert lp.dtype == torch.float32 and lp.shape == (2 * rows, L, V)
            return lp.gather(2, flat[..., None])[..., 0]

        valid = flat != port.pad_id
        assert valid.any()
        got = replay(decode_train_keys(seed).dropout)
        np.testing.assert_allclose(got[valid].numpy(), seq_lp.reshape(-1, L)[valid].numpy(), rtol=0, atol=LP_TOL)
        assert (replay(decode_train_keys(seed + 1).dropout) - got)[valid].abs().max() > 1e-3
        eval_seq, _ = generate(port, _port_encode(port), {**opt, "decode_train": False}, rng=seed)
    assert not torch.equal(seq, eval_seq)  # the train policy is really on


# ------------------------------------------------------- whole SCST step
CFG = dict(lr_scheduler="step", learning_rate=5e-5, optim="adam", grad_clip=0.1, scst_num_samples=3,
           scst_sample="random", scst_baseline="sample", scst_reward="device", max_seq_length=L + 1, seed=8)
BLEU = (0.0, 0.0, 0.0, 1.0)


@pytest.fixture(scope="module")
def reward_table(tmp_path_factory):
    rng = np.random.default_rng(0)

    def sent():
        return " ".join(rng.choice(VOCAB[4:], rng.integers(3, 9)))

    df_path = str(tmp_path_factory.mktemp("df") / "df.p")
    build_df_pickle([[sent() for _ in range(5)] for _ in range(30)], df_path)
    df, ref_len = load_df_pickle(df_path)
    gts = [[sent() for _ in range(5)] for _ in range(2)]
    return df, ref_len, gts


def _scst_setup(reward_table, drop=0.0, sparsity=SPARSITY, **cfg):
    df, ref_len, gts = reward_table
    jm, variables, port = _mask_freeze(drop=drop, sparsity=sparsity)
    config = dict(CFG, **cfg)
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), config, port_optim.make_schedule(config))
    opt_m = port_optim.build_mask_optimizer(masks.values(), config, trainable=False)
    table = port_devr.DfTable.build(df, ref_len, TOK2ID)
    reward_fn = port_devr.make_reward_fn(table, bleu_weight=BLEU)
    step = make_scst_step(port, opt_w, opt_m, config, reward_fn)
    att, amask, fc = make_inputs()
    batch = dict(att_feats=t(att), att_masks=t(amask), fc_feats=t(fc),
                 ref_pack=port_devr.scst_ref_pack(gts, df, table, TOK2ID, V, "cpu"))
    return jm, variables, port, step, reward_fn, batch


def test_scst_step_matches_jax_differentiable_scan(reward_table):
    """One two-phase SCST step of the paper's Up-Down recipe (mask_freeze at
    0.991, 2 images x 3 samples, leave-one-out baseline, CIDEr-D + BLEU-4,
    step LR 5e-5, Adam, grad clip 0.1, dropout 0) against the JAX package's
    gradient path for Up-Down: the sampling decode re-run as a differentiable
    scan inside ``jax.value_and_grad`` (``engine/training.py:768-770``). Its
    tokens feed the port's ``grad_fn``, which replays the unrolled steps:
    rewards, loss, every gradient and every parameter after the update."""
    df, ref_len, gts = reward_table
    jm, variables, port, step, _, batch = _scst_setup(reward_table)
    key = jax.random.PRNGKey(17)
    opt = {"num_random_sample": 3, "beam_size": 0, "max_seq_length": L, "decode_train": True}
    params, masks = variables["params"], variables["masks"]

    def sample(params, masks, differentiable):
        v = {"params": params, "masks": masks}
        memory = _jax_encode(jm, v, train=True)
        return jax_generate(jm, v, memory, dict(opt, differentiable=differentiable), rng=key)

    seq = np.asarray(sample(params, masks, False)[0])
    flat = seq.reshape(6, L)
    assert (flat != 0).sum() > 12 and len(np.unique(flat)) > 5
    table_j = devr.DfTable.build(df, ref_len, TOK2ID)
    pack_j = devr.ref_pack_device(devr.build_ref_pack(gts, df, ref_len, TOK2ID, vocab_size=V))
    score = devr.make_reward_device_fn(table_j, cider_weight=1.0, bleu_weight=BLEU)
    sc = score(jnp.asarray(flat), jnp.repeat(jnp.arange(2), 3), table_j.device_arrays(), pack_j)
    rewards = sc - devr.leave_one_out_baseline(sc, 3)

    def loss_fn(params, masks):
        seq2, seq_lp = sample(params, masks, True)
        loss = jax_losses.reward_loss(seq_lp.reshape(6, L), (jnp.asarray(flat) != 0).astype(jnp.float32), rewards)
        return loss, seq2

    (ref_loss, seq2), (gw, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(params, masks)
    np.testing.assert_array_equal(np.asarray(seq2), seq)  # the scan re-draws the same tokens
    opt_w = jax_optim.build_weight_optimizer(CFG, jax_optim.make_schedule(CFG))
    uw, _ = opt_w.update(gw, opt_w.init(params), params)
    new_params = optax.apply_updates(params, uw)

    state, loss, aux = step.grad_fn(TrainState(), batch, {"sample": t(seq)})
    assert state.step == 1
    np.testing.assert_allclose(float(aux["avg_sample"]), float(jnp.mean(sc)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["avg_reward"]), float(jnp.mean(rewards)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert abs(float(ref_loss)) > 1e-4
    grads = convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False)
    after = convert_jax_variables(to_numpy({"params": new_params, "masks": masks}), fold_masks=False)
    named = dict(port.named_parameters())
    assert set(grads) == set(named)
    top = max(float(g.abs().max()) for g in grads.values())
    lr = CFG["learning_rate"]
    for name, g in grads.items():
        gtol = 1e-5 * float(g.abs().max()) + 1e-6 * top
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0, atol=gtol, err_msg=name)
        noisy = (g.abs() <= gtol).numpy()
        atol = 0.0 if name.endswith(".mask") else 1e-7 + 2 * lr * noisy
        err = np.abs(named[name].detach().numpy() - after[name].numpy())
        allowed = atol + 1e-6 * np.abs(after[name].numpy())
        assert (err <= allowed).all(), f"{name}: worst err/allowed {(err / allowed).max():.3g}"
    # the gradient reaches the sparse weights through the unrolled LSTM
    assert float(named["att_lstm.ih.mask"].grad.abs().max()) > 1e-6
    assert float(named["logit.0.mask"].grad.abs().max()) > 1e-3


def test_scst_step_runs_with_dropout_and_greedy_baseline(reward_table):
    """The Up-Down step with dropout 0.1 and the greedy baseline: the baseline
    is the greedy caption's reward, and a second step draws new samples.
    Supermask Up-Down SCST (ported) runs too: its step updates weights and
    masks."""
    _, _, port, step, reward_fn, batch = _scst_setup(reward_table, drop=0.1, sparsity=0.5, scst_baseline="greedy")
    res = step.sample_fn(TrainState(), batch)
    assert res["sample"].shape == (2, 3, L) and res["greedy"].shape == (2, 1, L)
    state, loss, aux = step.grad_fn(TrainState(), batch, res)
    assert np.isfinite(float(loss)) and state.step == 1
    sc_greedy = reward_fn(res["greedy"].reshape(2, L), torch.arange(2, dtype=torch.int32), batch["ref_pack"])
    np.testing.assert_allclose(float(aux["avg_baseline"]), float(sc_greedy.mean()), rtol=1e-6, atol=1e-7)
    assert not torch.equal(step.sample_fn(state, batch)["sample"], res["sample"])
    supermask = get_model("up_down_lstm_prune")(**KW, drop_prob_lm=0.1, device="cpu",
                                                mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    params, masks = split_params(supermask)
    before = {n: m.detach().clone() for n, m in masks.items()}
    config = dict(CFG, scst_baseline="greedy")
    opt_w = port_optim.build_weight_optimizer(params.values(), config, port_optim.make_schedule(config))
    opt_m = port_optim.build_mask_optimizer(masks.values(), config, trainable=True)
    state, loss, _ = make_scst_step(supermask, opt_w, opt_m, config, reward_fn)(TrainState(), batch)
    assert state.step == 1 and np.isfinite(float(loss))
    assert all(not torch.equal(m, before[n]) for n, m in masks.items())

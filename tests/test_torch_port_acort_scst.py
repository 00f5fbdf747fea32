"""ACORT's SCST stage in the PyTorch port against the JAX package on the CPU:
the radix regroup before the reward (K10's radix mode, its plain version
``kernels/cider_reward.py radix_to_word``), the reward of radix digits, the
device reward built from a run's tokenizer (``scst/device_reward.py
DeviceReward``), one whole two-phase SCST step of an ACORT-shaped model, the
keyed dropout sites of a shared layer's slots, the replay with dropout on,
and the head width 32 of the attention kernels' wrappers.

The ACORT-shaped model here has d 64 over 2 heads (dk 32, ACORT-small's
head width), 3 slots over the plan (0, 0, 1) on both sides, kv sharing, and
a radix vocabulary of base 20 (23 ids: pad 0, digits 1..20, bos 21, eos 22)
over a synthetic word vocabulary written by the test.

Tolerances: the regroup exactly; rewards against the JAX device function
1e-5 relative (+1e-6: the same f32 formula, summation order only); the step
as ``tests/test_torch_port_scst.py::test_scst_step_matches_jax`` holds it
(loss 1e-5 relative, each gradient within 1e-5 of its tensor's largest
entry plus 1e-6 of the largest gradient anywhere, params after the Adam
update within the bounds that test derives); the replay's log-probs 1e-4
(f32, the parallel pass against the step decode: rounding only).
"""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import F, make_inputs, t, to_numpy
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.engine import optim as jax_optim
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.scst import device_reward as devr
from sparse_caption_tpu_torch import config as port_config
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import TrainState, make_scst_step
from sparse_caption_tpu_torch.kernels import _checks, launch_counts
from sparse_caption_tpu_torch.kernels.cider_reward import RadixSpec, radix_to_word
from sparse_caption_tpu_torch.kernels.decoder_attention import bf16_backward_smem, bf16_forward_smem
from sparse_caption_tpu_torch.kernels.grouped_cross_attention import bf16_smem as k3_bf16_smem
from sparse_caption_tpu_torch.metrics.cider import build_df_pickle, load_df_pickle
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.models import layers as pl
from sparse_caption_tpu_torch.ops import rng as port_rng
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, decode_train_keys, site_id
from sparse_caption_tpu_torch.scst import device_reward as port_devr
from sparse_caption_tpu_torch.tokenizers import get_tokenizer
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

KEY = jax.random.PRNGKey(0)
PLAN = (0, 0, 1)
D, HEADS, FF = 64, 2, 128  # dk 32
BASE, LEN = 20, 10  # radix base; max_seq_length (9 sampled digits)
WORDS = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(56)]  # 57 word slots: 2 digits a word
V, PAD, BOS, EOS = BASE + 3, 0, BASE + 1, BASE + 2
BLEU = (0.0, 0.0, 0.0, 1.0)
LP_TOL = 1e-4


def _tokenizer(tmp_path, words=WORDS, base=BASE):
    """The port's radix tokenizer over ``words`` (written as the word
    tokenizer's artifact) and the run config it completed."""
    os.makedirs(tmp_path / "tokenizer", exist_ok=True)
    with open(tmp_path / "tokenizer" / "word.vocab.json", "w") as f:
        json.dump({"model_type": "word", "vocab": list(words)}, f)
    pc = port_config.Config(log_dir=str(tmp_path), tokenizer="radix", radix_base=base, max_seq_length=LEN,
                            scst_bleu_weight=list(BLEU))
    return get_tokenizer("radix")(pc), pc


def _digits(value, base, tpw):
    """The radix digits (each + 1) of word value ``value``, most significant first."""
    return [(value // base ** (tpw - 1 - j)) % base + 1 for j in range(tpw)]


def _regroup_rows(base, tpw, n_words, t_len=11, n=24, seed=0):
    """Seeded digit rows with every case the regroup must take: eos first and
    last, bos and pad mid-row, a tail of one digit, word values at and past
    n_words - 1 (the <unk> slot and beyond the vocabulary)."""
    rng = np.random.default_rng(seed)
    eos, bos = base + 2, base + 1
    rows = rng.integers(1, base + 1, size=(n, t_len)).astype(np.int32)
    for r in range(4, n, 3):
        rows[r, rng.integers(1, t_len - 1)] = rng.choice([0, bos])  # pad or bos mid-row
    rows[0, 0] = eos  # empty caption
    rows[1, -1] = eos  # eos last
    rows[2, :] = 0
    rows[2, :3] = [bos, 2, 0]  # a tail of one digit
    rows[3, : 2 * tpw + 1] = _digits(n_words - 1, base, tpw) + _digits(min(n_words, base ** tpw - 1), base, tpw) + [eos]
    rows[5, :tpw] = _digits(base ** tpw - 1, base, tpw)  # the largest value
    rows[6, 1:] = eos  # one digit, then eos
    rows[7, 2:4] = [eos, 3]  # digits after the first eos are dropped
    return rows


def _host_word_ids(tok, row):
    """The tokenizer's host decode of a digit row as word ids (its strings
    mapped back through the word vocabulary: <unk> 1)."""
    words = tok.decode(list(row)).split()
    return [tok._token_to_id.get(w, 1) for w in words]


@pytest.mark.parametrize("base,n_vocab", [(BASE, len(WORDS)), (5, 70), (768, 10000)])
def test_radix_regroup_matches_jax_and_host_decode(tmp_path, base, n_vocab):
    words = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(n_vocab - 4)]
    tok, _ = _tokenizer(tmp_path, words, base)
    tpw = tok.tokens_per_word
    assert tpw == (3 if base == 5 else 2)
    rows = _regroup_rows(base, tpw, n_vocab - 3)
    fn = jax.jit(jax.vmap(devr.make_radix_to_word_fn(base, tpw, n_vocab)))
    want = np.asarray(fn(jnp.asarray(rows)))
    got = radix_to_word(t(rows), RadixSpec(base, tpw, n_vocab))
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows.shape[0], -(-rows.shape[1] // tpw))
    np.testing.assert_array_equal(got.numpy(), want)
    for r, row in enumerate(rows):
        host = _host_word_ids(tok, row)
        np.testing.assert_array_equal(got[r, : len(host)].numpy(), host, err_msg=f"row {r}")
        assert (got[r, len(host):] == 0).all()
    assert (got[0] == 0).all() and (got[3, :2] == 1).all()  # the empty caption; both <unk> values
    assert got[2, 0] == 4 + base ** (tpw - 1) and got[2, 1] == 0  # the one-digit tail, filled with digit 1


# ------------------------------------------------------------------ reward
@pytest.fixture(scope="module")
def radix_setup(tmp_path_factory):
    """(tokenizer, config, df path, gts, digit ids, img_idx): references over
    the word vocabulary with an OOV word, sampled-looking digit rows."""
    tmp = tmp_path_factory.mktemp("acort_scst")
    tok, pc = _tokenizer(tmp)
    rng = np.random.default_rng(3)

    def sent(lo=3, hi=8):
        return " ".join(rng.choice(WORDS[4:], rng.integers(lo, hi)))

    df_path = str(tmp / "df.p")
    build_df_pickle([[sent() for _ in range(5)] for _ in range(30)], df_path)
    b, spi = 4, 3
    gts = [[sent() for _ in range(int(rng.integers(2, 5)))] for _ in range(b)]
    gts[0][0] += " zzz"  # an OOV ref word: its private id clears every WORD id
    ids = np.stack([np.asarray(tok.encode(s, max_seq_length=LEN)[1:] + [0] * LEN, np.int32)[: LEN - 1]
                    for refs in gts for s in refs[:1] * spi])
    ids[1] = _regroup_rows(BASE, 2, len(WORDS) - 3, LEN - 1, seed=5)[1]  # random digits, eos last
    ids[4, 3:5] = [0, BOS]  # pad and bos mid-caption
    img_idx = np.repeat(np.arange(b), spi).astype(np.int32)
    return tok, pc, df_path, gts, ids, img_idx


@pytest.mark.parametrize("bleu", [(0.0, 0.0, 0.0, 0.0), BLEU])
def test_radix_reward_matches_jax_device_fn(radix_setup, bleu):
    """``make_reward_fn(regroup=RadixSpec)`` against ``make_reward_device_fn(
    regroup=make_radix_to_word_fn(...))`` with the word-level eos / pad / bos
    (``engine/training.py:291``): CIDEr only and CIDEr + BLEU-4."""
    tok, _, df_path, gts, ids, img_idx = radix_setup
    df, ref_len = load_df_pickle(df_path)
    tok2id, n_vocab = dict(tok._token_to_id), len(tok.vocab)
    table_j = devr.DfTable.build(df, ref_len, tok2id)
    pack_j = devr.build_ref_pack(gts, df, ref_len, tok2id, vocab_size=n_vocab)
    fn = jax.jit(devr.make_reward_device_fn(table_j, eos_id=3, pad_id=0, bos_id=2, bleu_weight=bleu,
                                            regroup=devr.make_radix_to_word_fn(BASE, 2, n_vocab)))
    want = np.asarray(fn(jnp.asarray(ids), jnp.asarray(img_idx), table_j.device_arrays(),
                         devr.ref_pack_device(pack_j)))
    table = port_devr.DfTable.build(df, ref_len, tok2id)
    score = port_devr.make_reward_fn(table, bleu_weight=bleu, regroup=RadixSpec(BASE, 2, n_vocab))
    got = score(t(ids), t(img_idx), port_devr.ref_pack_to(port_devr.build_ref_pack(
        gts, df, ref_len, tok2id, vocab_size=n_vocab), "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (want > 0).sum() >= 6
    with pytest.raises(TypeError, match="RadixSpec"):
        port_devr.make_reward_fn(table, regroup=devr.make_radix_to_word_fn(BASE, 2, n_vocab))


def test_device_reward_from_the_radix_tokenizer(radix_setup):
    """``DeviceReward`` (the port of ``_init_device_reward`` +
    ``_scst_ref_pack``) from the radix tokenizer: the WORD map and the word
    vocabulary size (private OOV ref ids from 60, not 23), the regroup spec,
    the config's weights; its scores equal the JAX scorer's on the same
    bucketed pack."""
    tok, pc, df_path, gts, ids, img_idx = radix_setup
    reward = port_devr.DeviceReward.from_pickle(tok, df_path, pc)
    assert reward.regroup == RadixSpec(BASE, 2, len(WORDS)) and reward.vocab_size == len(WORDS)
    assert reward.tok2id == {w: i for i, w in enumerate(WORDS)}
    pack = reward.ref_pack(gts, "cpu")
    assert pack["hi"].shape[2] % 32 == 0
    oov = pack["lo"][0, 0][(pack["lo"][0, 0] & 0xFFFF) - 1 >= len(WORDS)]
    assert oov.numel() > 0 and ((oov & 0xFFFF) - 1 == len(WORDS)).any()  # the first private id is 60
    df, ref_len = load_df_pickle(df_path)
    table_j = devr.DfTable.build(df, ref_len, reward.tok2id)
    r, gram_ub = max(len(x) for x in gts), max(4 * len(s.split()) for refs in gts for s in refs)
    pack_j = devr.build_ref_pack(gts, df, ref_len, reward.tok2id, vocab_size=len(WORDS), max_refs=r,
                                 max_grams=-(-gram_ub // 32) * 32)
    fn = devr.make_reward_device_fn(table_j, bleu_weight=BLEU,
                                    regroup=devr.make_radix_to_word_fn(BASE, 2, len(WORDS)))
    want = np.asarray(fn(jnp.asarray(ids), jnp.asarray(img_idx), table_j.device_arrays(),
                         devr.ref_pack_device(pack_j)))
    np.testing.assert_allclose(reward.fn(t(ids), t(img_idx), pack).numpy(), want, rtol=1e-5, atol=1e-6)
    word = get_tokenizer("word")(port_config.Config(log_dir=os.path.dirname(os.path.dirname(tok.vocab_path))))
    assert port_devr.DeviceReward(word, df, ref_len, {}).regroup is None


# ------------------------------------------------------- whole SCST step
def _acort_kw(dropout=0.0, plan=PLAN):
    return dict(vocab_size=V, d_model=D, dim_feedforward=FF, num_layers=len(plan), num_heads=HEADS,
                att_feat_size=F, max_seq_length=LEN, pad_id=PAD, bos_id=BOS, eos_id=EOS, share_att_encoder="kv",
                share_att_decoder="kv", share_layer_encoder=plan, share_layer_decoder=plan, dropout_rate=dropout,
                drop_prob_src=dropout)


def _acort_models(dropout=0.0, plan=PLAN, seed=4):
    inputs = make_inputs(seed=seed)
    att, amask, boxes, _ = inputs
    seqs = np.full((2, LEN), PAD, np.int32)
    seqs[:, :4] = [BOS, 3, 4, EOS]
    jm = JaxORT(**_acort_kw(dropout, plan))
    jv = to_numpy(jm.init(KEY, *(jnp.asarray(a) for a in (att, amask, seqs, boxes))))
    port = load_jax_variables(get_model("relation_transformer")(**_acort_kw(dropout, plan), device="cpu"), jv)
    assert port.d_model // port.num_heads == 32
    return jm, jv, port, inputs


CFG = dict(lr_scheduler="step", learning_rate=5e-5, optim="adam", grad_clip=0.1, scst_num_samples=3,
           scst_sample="random", scst_baseline="sample", scst_reward="device", max_seq_length=LEN, seed=8,
           scst_bleu_weight=list(BLEU))


def test_acort_scst_step_matches_jax(radix_setup):
    """One two-phase SCST step of the ACORT-shaped model (2 images x 3
    samples; step LR 5e-5, Adam, clip 0.1, sample baseline, CIDEr + BLEU-4 of
    the regrouped digits, dropout 0) against the JAX package's device-reward
    replay update on the same tokens: rewards, loss, every gradient (a shared
    layer's summed over its slots) and every param after the update."""
    tok, _, df_path, gts, _, _ = radix_setup
    jm, jv, port, inputs = _acort_models()
    reward = port_devr.DeviceReward.from_pickle(tok, df_path, CFG)
    params, masks = split_params(port)
    assert not masks
    opt_w = port_optim.build_weight_optimizer(params.values(), CFG, port_optim.make_schedule(CFG))
    opt_m = port_optim.build_mask_optimizer(masks.values(), CFG, trainable=False)
    step = make_scst_step(port, opt_w, opt_m, CFG, reward.fn)
    att, amask, boxes, _ = inputs
    batch = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes))
    res = step.sample_fn(TrainState(), batch)
    sample = res["sample"]
    assert sample.shape == (2, 3, LEN - 1)
    # references that share words with the samples, so that the rewards differ
    gts = [[tok.decode(sample[i, 0].tolist()) + " w7", tok.decode(sample[i, 1].tolist())[:12], gts[i][0]]
           for i in range(2)]
    batch["ref_pack"] = reward.ref_pack(gts, "cpu")
    before = launch_counts()
    state, loss, aux = step.grad_fn(TrainState(), batch, res)
    assert launch_counts() == before and state.step == 1

    flat = sample.reshape(6, LEN - 1).numpy()
    df, ref_len = load_df_pickle(df_path)
    table_j = devr.DfTable.build(df, ref_len, reward.tok2id)
    r, gram_ub = max(len(x) for x in gts), max(4 * len(s.split()) for refs in gts for s in refs)
    pack_j = devr.ref_pack_device(devr.build_ref_pack(gts, df, ref_len, reward.tok2id, vocab_size=len(WORDS),
                                                      max_refs=r, max_grams=-(-gram_ub // 32) * 32))
    score = devr.make_reward_device_fn(table_j, bleu_weight=BLEU,
                                       regroup=devr.make_radix_to_word_fn(BASE, 2, len(WORDS)))
    sc = score(jnp.asarray(flat), jnp.repeat(jnp.arange(2), 3), table_j.device_arrays(), pack_j)
    rewards = sc - devr.leave_one_out_baseline(sc, 3)
    np.testing.assert_allclose(float(aux["avg_sample"]), float(jnp.mean(sc)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["avg_reward"]), float(jnp.mean(rewards)), rtol=1e-5, atol=1e-6)
    assert float(jnp.abs(rewards).max()) > 1e-3
    seqs_in = jnp.concatenate([jnp.full((6, 1), BOS, jnp.int32), jnp.asarray(flat)], axis=1)

    def loss_fn(params):
        v = {"params": params}
        memory = jm.apply(v, *(jnp.asarray(a) for a in inputs[:3]), train=True, rngs={"dropout": KEY},
                          method="encode")
        lp = jm.apply(v, memory, seqs_in, True, method="decode_teacher_forced", rngs={"dropout": KEY})
        seq_lp = jnp.take_along_axis(lp, jnp.asarray(flat)[..., None], axis=2)[..., 0]
        return jax_losses.reward_loss(seq_lp, (jnp.asarray(flat) != PAD).astype(jnp.float32), rewards)

    ref_loss, gw = jax.value_and_grad(loss_fn)(jv["params"])
    jopt = jax_optim.build_weight_optimizer(CFG, jax_optim.make_schedule(CFG))
    uw, _ = jopt.update(gw, jopt.init(jv["params"]), jv["params"])
    new_params = optax.apply_updates(jv["params"], uw)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    assert abs(float(ref_loss)) > 1e-4
    grads = convert_jax_variables(to_numpy({"params": gw}))
    after = convert_jax_variables(to_numpy({"params": new_params}))
    named = dict(port.named_parameters())
    assert set(grads) == set(named) and "decoder_layers.0.self_attn.kv_proj.weight" in named
    top = max(float(g.abs().max()) for g in grads.values())
    lr = CFG["learning_rate"]
    for name, g in grads.items():
        gtol = 1e-5 * float(g.abs().max()) + 1e-6 * top
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0, atol=gtol, err_msg=name)
        noisy = (g.abs() <= gtol).numpy()  # an entry within its tolerance of 0 may move the other way
        err = np.abs(named[name].detach().numpy() - after[name].numpy())
        allowed = 1e-7 + 2 * lr * noisy + 1e-6 * np.abs(after[name].numpy())
        assert (err <= allowed).all(), f"{name}: worst err/allowed {(err / allowed).max():.3g}"


# ----------------------------------------------------------- dropout sites
def _recorded_sites(model, run):
    """The site of every keyed draw ``run`` makes (K8's plain version)."""
    sites = []
    real_mask, real_drop = port_rng.keyed_keep_mask, port_rng.keyed_dropout

    def mask(key, site, *args, **kwargs):
        sites.append(site)
        return real_mask(key, site, *args, **kwargs)

    def drop(x, key, site, *args, **kwargs):
        sites.append(site)
        return real_drop(x, key, site, *args, **kwargs)

    with mock.patch.object(port_rng, "keyed_keep_mask", mask), mock.patch.object(port_rng, "keyed_dropout", drop):
        with torch.no_grad():
            run()
    return sites


def _replay_pass(model, inputs, key=3):
    att, amask, boxes, _ = inputs
    seqs = torch.full((4, LEN), PAD, dtype=torch.long)
    seqs[:, :5] = torch.tensor([BOS, 3, 7, 2, EOS])
    memory = model.encode(t(att), t(amask), t(boxes), train=True, rng=KeyedStream(key))
    return model.decode_teacher_forced(memory, seqs, train=True, rng=KeyedStream(key + 1))


def test_shared_layer_slots_draw_under_sites_of_their_own():
    """With dropout on, a train-mode encode and replay of the ACORT-shaped
    model draw each (module, slot) once, every draw under a different site
    (giving a shared layer's slots one site fails here); slot 0 keeps the
    module's own site; an unshared model's draws are exactly PR 12's sites,
    each module's ``site_id`` of its qualified name."""
    _, _, shared, inputs = _acort_models(dropout=0.1)
    sites = _recorded_sites(shared, lambda: _replay_pass(shared, inputs))
    # src; 3 encoder slots x (attention probs, ffn, 2 sublayers); PE; 3 decoder slots x (ffn, 3 sublayers)
    assert len(sites) == 1 + 3 * 4 + 1 + 3 * 4
    assert len(set(sites)) == len(sites)
    own = {m.site for m in shared.modules() if isinstance(m, pl.DropoutSite)}
    assert len(own & set(sites)) == 1 + 2 * 4 + 1 + 2 * 4  # slot 0 of each unique layer, and the unshared calls
    slot1 = [port_rng.slot_site(shared.decoder_layers[0].sub0.site, 1)]
    assert slot1[0] in sites and slot1[0] != shared.decoder_layers[0].sub0.site

    _, _, unshared, inputs = _acort_models(dropout=0.1, plan=(0, 1, 2))
    sites = _recorded_sites(unshared, lambda: _replay_pass(unshared, inputs))
    names = {site_id(name or "root"): name for name, m in unshared.named_modules() if isinstance(m, pl.DropoutSite)}
    assert len(sites) == len(set(sites)) == 1 + 3 * 4 + 1 + 3 * 4 and set(sites) <= set(names)
    assert all(port_rng.slot_site(s, 0) == s for s in sites)


def test_acort_replay_equals_sampling_with_dropout():
    """The port's replay holds with shared layers: at dropout 0.1 on both
    sides, the teacher-forced replay of a 2 x 3 sampling decode under its
    keyed stream gives the decode's log-probs at every non-pad position
    within 1e-4; another stream does not. The sampling decode projects the
    cross K/V once per slot (``init_cache(train=True)``), as the replay does."""
    _, _, port, inputs = _acort_models(dropout=0.1)
    att, amask, boxes, _ = inputs
    rows, seed = 3, 41
    opt = {"num_random_sample": rows, "beam_size": 0, "max_seq_length": LEN - 1, "decode_train": True}
    src_attn = {id(layer.src_attn) for layer in port.decoder_layers}
    calls = []
    real = pl.MultiHeadAttention.project_memory_kv

    def counting(self, *args, **kwargs):
        if id(self) in src_attn:
            calls.append(id(self))
        return real(self, *args, **kwargs)

    with torch.no_grad(), mock.patch.object(pl.MultiHeadAttention, "project_memory_kv", counting):
        memory = port.encode(t(att), t(amask), t(boxes), train=True, rng=KeyedStream(8))
        seq, seq_lp = generate(port, memory, opt, rng=seed)
        assert len(calls) == len(PLAN)  # one projection a slot in the sampling decode's cache
        flat = seq.reshape(-1, LEN - 1).long()
        seqs_in = torch.cat([torch.full((flat.shape[0], 1), BOS), flat], 1)

        def replay(key):
            lp = port.decode_teacher_forced(memory, seqs_in, train=True, rng=KeyedStream(key))
            return lp.gather(2, flat[..., None])[..., 0]

        got = replay(decode_train_keys(seed).dropout)
        assert len(calls) == 2 * len(PLAN)  # and one a slot in the replay
        valid = flat != PAD
        assert valid.sum() > 6
        np.testing.assert_allclose(got[valid].numpy(), seq_lp.reshape(-1, LEN - 1)[valid].numpy(), rtol=0,
                                   atol=LP_TOL)
        assert (replay(decode_train_keys(seed + 1).dropout) - got)[valid].abs().max() > 1e-3


def test_scst_step_runs_with_dropout_over_shared_layers(radix_setup):
    """The step itself with the recipe's dropout (0.1 on both sides): finite
    loss, one update, and the next step samples anew."""
    tok, _, df_path, gts, _, _ = radix_setup
    _, _, port, inputs = _acort_models(dropout=0.1)
    reward = port_devr.DeviceReward.from_pickle(tok, df_path, CFG)
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), CFG, port_optim.make_schedule(CFG))
    opt_m = port_optim.build_mask_optimizer(masks.values(), CFG, trainable=False)
    step = make_scst_step(port, opt_w, opt_m, CFG, reward.fn)
    att, amask, boxes, _ = inputs
    batch = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes), ref_pack=reward.ref_pack(gts[:2], "cpu"))
    state, loss, aux = step(TrainState(), batch)
    assert state.step == 1 and np.isfinite(float(loss)) and np.isfinite(float(aux["avg_sample"]))
    assert not torch.equal(step.sample_fn(state, batch)["sample"], step.sample_fn(TrainState(), batch)["sample"])


# ------------------------------------------------------------ head width 32
def test_head_widths_and_shared_memory_at_dk32():
    """The attention wrappers take dk 13 (ORT-xsmall's, staged at 16), 32 and
    64 and refuse the rest; the bf16 kernels' shared memory at dk 32 counted
    by hand: rows of 2 (dk + 8) = 80 bytes."""
    for dk in (13, 32, 64):
        _checks.check_head_width(dk, "box_attention")
    for dk in (12, 16, 128):
        with pytest.raises(ValueError, match="head widths"):
            _checks.check_head_width(dk, "box_attention")
    # K3: (stages x ((2 or 1) x regions + rep) x 2 heads + 1 flag row) + a zero row
    assert k3_bf16_smem(36, 5, dk=32) == (2 * ((2 * 36 + 5) * 2 + 1) + 1) * 80 == 24_880
    assert k3_bf16_smem(36, 5, kv=True, dk=32) == (2 * ((36 + 5) * 2 + 1) + 1) * 80
    assert k3_bf16_smem(36, 5) == (2 * ((2 * 36 + 5) * 2 + 1) + 1) * 144
    # K14: 2 stages of (K, V, the group's q rows) and keep flags, + a zero row; K15: + dS and P~
    keep_pitch = 16 * -(-(25 * 36 + 15) // 16)
    assert bf16_forward_smem(25, 36, 15, True, dk=32) == 2 * (2 * (2 * 36 + 15 * 25) * 40 + 15 * keep_pitch) + 80
    assert bf16_backward_smem(25, 25, 5, dk=32) == 2 * (2 * (2 * 25 + 2 * 5 * 25) * 40 + 40 + 2 * 5 * 32 * 40)
    # the SCST replay's cross call (15 samples of 25 positions over 36 regions): one stage at either width
    assert bf16_backward_smem(25, 36, 15, dk=32) == 2 * ((2 * 36 + 2 * 15 * 25) * 40 + 40 + 2 * 15 * 32 * 56)
    assert bf16_backward_smem(25, 36, 15) == 2 * ((2 * 36 + 2 * 15 * 25) * 72 + 72 + 2 * 15 * 32 * 56)


def test_supermask_scst_over_shared_layers_draws_per_slot_and_moves_every_mask(radix_setup):
    """A supermask SCST step of the ACORT-shaped model (kv, plan (0, 0, 1),
    dropout 0.1; once refused) runs: the gradient pass re-runs the decode
    through K2's and K3's kv backward (plain versions here), every slot of a
    shared layer draws its own keyed sample, the loss is finite and not 0
    (the sampled rewards differ within an image), and the mask Adam moves
    every mask logit tensor (the generator's bias favours the words' first
    digits, so that samples decode to words). The weights come from a seeded
    generator: drawn from torch's global one, they depended on the tests that
    ran before in the process; where every sample of an image gets the same
    reward, no gradient flows and no mask moves."""
    tok, _, df_path, gts, _, _ = radix_setup
    att, amask, boxes, _ = make_inputs(seed=1)
    port = get_model("relation_transformer_prune")(**_acort_kw(0.1), device="cpu",
                                                   mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True),
                                                   generator=torch.Generator().manual_seed(5))
    params, masks = split_params(port)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in masks.values():
            m.copy_(torch.randn(m.shape, generator=g))
        port.generator.proj.bias[1:4] += 3.0  # first digits of the 56 words: samples that decode to words
        port.generator.proj.bias[EOS] -= 2.0
    before = {n: m.detach().clone() for n, m in masks.items()}
    reward = port_devr.DeviceReward.from_pickle(tok, df_path, CFG)
    opt_w = port_optim.build_weight_optimizer(params.values(), CFG, port_optim.make_schedule(CFG))
    opt_m = port_optim.build_mask_optimizer(masks.values(), CFG, trainable=True)
    step = make_scst_step(port, opt_w, opt_m, CFG, reward.fn)
    batch = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes), ref_pack=reward.ref_pack(gts[:2], "cpu"))
    sites = []
    real = KeyedStream.mask_draw

    def logged(self, layer, shape, device):
        sites.append((layer.mask_site, self.slot))
        return real(self, layer, shape, device)

    with mock.patch.object(KeyedStream, "mask_draw", logged):
        state, loss, _ = step(TrainState(), batch)
    assert state.step == 1 and np.isfinite(float(loss)) and float(loss) != 0.0
    shared = port.decoder_layers[0].feed_forward.w_1.mask_site
    assert {slot for site, slot in sites if site == shared} == {0, 1}  # slots 0 and 1 of decoder layer 0
    for name, m in masks.items():
        assert not torch.equal(m.detach(), before[name]), name

"""SCST slice of the PyTorch port against the JAX package on the CPU: the
keyed dropout stream (K8's plain version), the sampling decode (K9's),
the teacher-forced replay, the CIDEr-D + BLEU reward (K10's) with its
leave-one-out baseline, and one whole two-phase SCST step of a mask_freeze
ORT.

Random streams cannot be shared between the frameworks: the sampling test
replays the JAX decode's Gumbel noise into the port (``generate(...,
noise=...)``), and the model tests run at dropout 0 except the port-internal
replay test, which holds the replay to the port's own sampling decode with
dropout on.

Tolerances: log-probs 1e-5 absolute (f32, summation order only); the reward
against the JAX device function rtol 1e-5 / atol 1e-6 (the same f32 formula)
and against the host ``CiderScorer`` rtol 2e-4 / atol 2e-5 (f64 on the host);
the baseline exactly; the whole step's loss 1e-5 relative, each gradient
within 1e-5 of its tensor's largest entry plus 1e-6 of the largest gradient
of all (the key projections' biases have a gradient of 0 in exact
arithmetic, which both sides give as rounding noise up to 2.6e-7 of the
largest; the geometry weight ``wg`` sums B * R * R pairs under rewards of
both signs, 1.2e-5 of its own largest entry on this data), params after the
Adam update as ``test_torch_port_train.py`` bounds them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import KW, jax_mask_cfg, jax_variables, make_inputs, t, to_numpy
from sparse_caption_tpu.decoding import generate as jax_generate
from sparse_caption_tpu.decoding.api import decode_train_keys as jax_decode_train_keys
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.engine import optim as jax_optim
from sparse_caption_tpu.metrics.cider import CiderScorer
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.scst import device_reward as devr
from sparse_caption_tpu_torch.decoding import generate
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import (
    TrainState,
    make_scst_fused_step,
    make_scst_pipelined_step,
    make_scst_step,
)
from sparse_caption_tpu_torch.kernels import launch_counts
from sparse_caption_tpu_torch.kernels.cider_reward import cider_reward_plain
from sparse_caption_tpu_torch.kernels.keyed_dropout import keyed_dropout, keyed_keep_mask, philox4x32_10
from sparse_caption_tpu_torch.kernels.sample_step import gumbel_noise
from sparse_caption_tpu_torch.metrics.cider import build_df_pickle, load_df_pickle
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params
from sparse_caption_tpu_torch.ops.rng import KeyedStream, decode_train_keys
from sparse_caption_tpu_torch.scst import device_reward as port_devr
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

V, L = KW["vocab_size"], KW["max_seq_length"]
LP_TOL = 1e-5
VOCAB = ["<pad>", "<unk>", "<bos>", "<eos>"] + [f"w{i}" for i in range(4, V)]
TOK2ID = {w: i for i, w in enumerate(VOCAB)}


def _mask_freeze(dropout: float = 0.0, mask_seed: int = 21):
    """JAX ORT with frozen 0/1 masks, its variables, and the port model with
    the masks kept unfolded."""
    inputs = make_inputs(seed=4)
    jm = JaxORT(**KW, dropout_rate=dropout, drop_prob_src=dropout, mask_cfg=jax_mask_cfg("mask_freeze"))
    variables = jax_variables(jm, inputs, mask_seed=mask_seed, mask_type="mask_freeze")
    port = get_model("relation_transformer_prune")(**KW, dropout_rate=dropout, drop_prob_src=dropout, device="cpu",
                                                   mask_cfg=MaskConfig("mask_freeze", keep_masks=True))
    return jm, variables, load_jax_variables(port, variables), inputs


def _jax_encode(jm, variables, inputs):
    att, amask, boxes, _ = inputs
    return jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")


def _port_encode(port, inputs, **kw):
    att, amask, boxes, _ = inputs
    return port.encode(t(att), t(amask), t(boxes), **kw)


# ------------------------------------------------------------ keyed stream
def test_philox_known_answers():
    """Random123's known-answer vectors of Philox4x32-10."""
    z = torch.zeros(1, dtype=torch.int64)
    assert [int(w) for w in philox4x32_10(z, z, z, z, 0)] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    o = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    assert [int(w) for w in philox4x32_10(o, o, o, o, 2 ** 64 - 1)] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6,
                                                                        0x6D5451FD]


def test_keyed_step_and_replay_draws_are_identical():
    stream, site, shape = KeyedStream(0xDEADBEEF12345678), 77, (6, 5, 9)
    replay = stream.keep_mask(shape, 0.9, "cpu", site)
    steps = torch.cat([stream.at(j).keep_mask((6, 1, 9), 0.9, "cpu", site) for j in range(5)], 1)
    assert torch.equal(replay, steps)
    x = torch.randn(shape)
    applied = torch.cat([stream.at(j).dropout(x[:, j: j + 1], 0.9, site) for j in range(5)], 1)
    assert torch.equal(stream.dropout(x, 0.9, site), applied)
    assert torch.equal(applied, torch.where(replay, x / 0.9, torch.zeros_like(x)))
    assert not torch.equal(replay, stream.keep_mask(shape, 0.9, "cpu", site + 1))  # sites differ
    assert not torch.equal(replay, KeyedStream(1).keep_mask(shape, 0.9, "cpu", site))  # keys differ
    with pytest.raises(ValueError, match="site"):
        stream.keep_mask(shape, 0.9, "cpu")
    with pytest.raises(ValueError, match="step view"):
        stream.at(3).keep_mask(shape, 0.9, "cpu", site)
    with pytest.raises(ValueError, match="mask_site"):  # a supermask draw is keyed by its layer's site
        stream.mask_uniform(None, (2, 2), "cpu")


def test_keyed_keep_rate_and_noise_range():
    p, n, tl, d = 0.9, 64, 17, 512
    keep = keyed_keep_mask(2024, 5, 0, n, tl, d, p, "cpu")
    sigma = (p * (1 - p) / keep.numel()) ** 0.5
    assert abs(keep.float().mean().item() - p) < 4 * sigma
    g = gumbel_noise(2024, 6, 3, 40, 1000, "cpu")
    assert torch.isfinite(g).all() and abs(g.mean().item() - 0.5772) < 0.02  # Euler-Mascheroni


def test_keyed_dropout_gradient_is_the_same_mask():
    x = torch.randn(3, 4, 8, requires_grad=True)
    out = keyed_dropout(x, 9, 11, 2, 0.8)
    (g,) = torch.autograd.grad(out, x, torch.ones_like(out))
    keep = keyed_keep_mask(9, 11, 2, 3, 4, 8, 0.8, "cpu")
    assert torch.equal(g, torch.where(keep, torch.full_like(g, 1 / 0.8), torch.zeros_like(g)))


# --------------------------------------------------------- sampling decode
def _jax_step_logprobs(jm, variables, memory, seq, rows, constraint):
    """The JAX decode's log-probs at every step, feeding it its own tokens."""
    n = seq.shape[0]
    cache = jm.apply(variables, memory, L, rows, False, method="init_cache")
    it = jnp.full((n,), 2, jnp.int32)
    out = []
    for step in range(L):
        lp, cache = jm.apply(variables, it, cache, step, memory, method="decode_step")
        lp = np.array(lp)
        if constraint and step > 0:
            lp[np.arange(n), np.asarray(it)] += np.float32(-1e30)
        out.append(lp)
        it = jnp.asarray(seq[:, step])
    return out


@pytest.mark.parametrize("mode,constraint", [("greedy", 0), ("greedy", 1), ("random", 0), ("random", 1)])
def test_sample_decode_matches_jax(mode, constraint):
    """Greedy and random sampling (temperature 0.7, JAX's Gumbel noise
    replayed) of a mask_freeze model: identical tokens, chosen log-probs
    within 1e-5 at non-pad positions."""
    jm, variables, port, inputs = _mask_freeze()
    memory = _jax_encode(jm, variables, inputs)
    if mode == "greedy":
        rows, noise = 1, None
        opt = {"beam_size": 1, "max_seq_length": L, "decoding_constraint": constraint}
        ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt))
    else:
        rows, temp = 3, 0.7
        opt = {"num_random_sample": rows, "beam_size": 0, "max_seq_length": L, "temperature": temp,
               "decoding_constraint": constraint, "decode_train": True}
        key = jax.random.PRNGKey(31)
        ref_seq, ref_lp = (np.asarray(x) for x in jax_generate(jm, variables, memory, opt, rng=key))
        # sample_decode's step keys: split off the decode's rng, one per step
        k, g = jax_decode_train_keys(key)[0], []
        for _ in range(L):
            k, sub = jax.random.split(k)
            g.append(np.asarray(jax.random.gumbel(sub, (2 * rows, V))))
        flat = ref_seq.reshape(2 * rows, L)
        lps = _jax_step_logprobs(jm, variables, memory, flat, rows, constraint)
        for step in range(L):
            live = ~(flat[:, :step] == 3).any(1)
            np.testing.assert_array_equal(np.argmax(lps[step] / np.float32(temp) + g[step], -1)[live],
                                          flat[live, step])
        noise = lambda step: t(g[step])  # noqa: E731
    before = launch_counts()
    seq, lp = generate(port, _port_encode(port, inputs), opt, rng=5, noise=noise)
    assert launch_counts() == before
    assert seq.shape == (2, rows, L)
    np.testing.assert_array_equal(seq.numpy(), ref_seq)
    valid = ref_seq != 0
    assert valid.any()
    np.testing.assert_allclose(lp.numpy()[valid], ref_lp[valid], rtol=0, atol=LP_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_decode_teacher_forced_matches_jax(train):
    """XE masking (``train=False``) and the replay's causal-only mask, at dropout 0."""
    jm, variables, port, inputs = _mask_freeze()
    seqs = np.repeat(inputs[3], 3, axis=0)  # 3 rows per image, with pads
    key = jax.random.PRNGKey(1)
    memory = jm.apply(variables, *(jnp.asarray(a) for a in inputs[:3]), train=train,
                      rngs={"dropout": key, "mask": key}, method="encode")
    ref = jm.apply(variables, memory, jnp.asarray(seqs), train, method="decode_teacher_forced",
                   rngs={"dropout": key})
    with torch.no_grad():
        mem = _port_encode(port, inputs, train=train, rng=KeyedStream(3) if train else None)
        out = port.decode_teacher_forced(mem, t(seqs).long(), train=train, rng=KeyedStream(4) if train else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=LP_TOL)


def test_replay_equals_sampling_with_dropout():
    """The port's mirror of ``tests/test_scst_semantics.py:151-187``: with
    dropout on (0.1 / 0.5), one teacher-forced replay under the decode's
    keyed stream gives the sampling decode's log-probs at every non-pad
    position; another stream does not."""
    _, _, port, inputs = _mask_freeze(dropout=0.1)
    port.drop_prob_src = 0.5
    rows, seed = 3, 99
    opt = {"num_random_sample": rows, "beam_size": 0, "max_seq_length": L, "decode_train": True}
    with torch.no_grad():
        memory = _port_encode(port, inputs, train=True, rng=KeyedStream(8))
        seq, seq_lp = generate(port, memory, opt, rng=seed)
        flat = seq.reshape(-1, L).long()
        seqs_in = torch.cat([torch.full((flat.shape[0], 1), port.bos_id), flat], 1)

        def replay(key):
            lp = port.decode_teacher_forced(memory, seqs_in, train=True, rng=KeyedStream(key))
            return lp.gather(2, flat[..., None])[..., 0]

        valid = flat != port.pad_id
        assert valid.any()
        got = replay(decode_train_keys(seed).dropout)
        np.testing.assert_allclose(got[valid].numpy(), seq_lp.reshape(-1, L)[valid].numpy(), rtol=0, atol=LP_TOL)
        assert (replay(decode_train_keys(seed + 1).dropout) - got)[valid].abs().max() > 1e-3
        eval_seq, _ = generate(port, _port_encode(port, inputs), {**opt, "decode_train": False}, rng=seed)
    assert not torch.equal(seq, eval_seq)  # the train policy is really on


# ------------------------------------------------------------------ reward
def _host_decode(ids):
    words = []
    for i in ids:
        if i == 3:
            break
        if i not in (0, 2):
            words.append(VOCAB[i] if 0 <= i < len(VOCAB) else "<unk>")
    return " ".join(words)


@pytest.fixture(scope="module")
def reward_setup(tmp_path_factory):
    rng = np.random.default_rng(0)

    def sent(lo=3, hi=12):
        return " ".join(rng.choice(VOCAB[4:], rng.integers(lo, hi)))

    corpus = [[sent() for _ in range(5)] for _ in range(30)]
    df_path = str(tmp_path_factory.mktemp("df") / "df.p")
    build_df_pickle(corpus, df_path)
    b, spi, tl = 6, 3, 12
    gts = [[sent() for _ in range(int(rng.integers(2, 6)))] for _ in range(b)]
    gts[0][0] += " zzz zzz qqq"  # OOV ref words never match a sampled id
    gts[1][0] += " <unk>"  # a literal <unk> ref word matches sampled id 1
    ids = rng.integers(0, V, (b * spi, tl)).astype(np.int32)
    ids[0, :] = 3  # empty caption
    ids[1, :4] = [5, 0, 2, 5]  # pad / bos noise inside the caption
    ids[1, 4:] = 3
    ids[2, :] = 7  # no EOS, maximal repetition
    ids[3, :6] = [8, 9, 8, 9, 8, 3]  # repeated bigrams
    img_idx = np.repeat(np.arange(b), spi).astype(np.int32)
    return df_path, gts, ids, img_idx


@pytest.mark.parametrize("bleu", [(0.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0), (0.5, 0.25, 0.0, 1.0)])
def test_reward_matches_jax_device_fn(reward_setup, bleu):
    df_path, gts, ids, img_idx = reward_setup
    scorer = CiderScorer.from_pickle(df_path)
    df, ref_len = load_df_pickle(df_path)
    assert ref_len == scorer.ref_len and dict(df) == dict(scorer.df)
    table_j = devr.DfTable.build(scorer.df, scorer.ref_len, TOK2ID)
    table = port_devr.DfTable.build(df, ref_len, TOK2ID)
    for k in ("hi", "lo", "val"):
        np.testing.assert_array_equal(getattr(table, k), getattr(table_j, k))
    assert table.probe == table_j.probe
    pack_j = devr.build_ref_pack(gts, scorer.df, scorer.ref_len, TOK2ID, vocab_size=V)
    pack = port_devr.build_ref_pack(gts, df, ref_len, TOK2ID, vocab_size=V)
    for k, v in pack_j.items():
        np.testing.assert_array_equal(pack[k], v)
    fn = jax.jit(devr.make_reward_device_fn(table_j, cider_weight=1.0, bleu_weight=bleu))
    want = np.asarray(fn(jnp.asarray(ids), jnp.asarray(img_idx), table_j.device_arrays(),
                         devr.ref_pack_device(pack_j)))
    score = port_devr.make_reward_fn(table, cider_weight=1.0, bleu_weight=bleu)
    got = score(t(ids), t(img_idx), port_devr.ref_pack_to(pack, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.any(want > 0)


def test_reward_matches_host_cider_scorer(reward_setup):
    df_path, gts, ids, img_idx = reward_setup
    df, ref_len = load_df_pickle(df_path)
    host = CiderScorer(df=df, ref_len=ref_len)
    for k in range(ids.shape[0]):
        host.append(_host_decode(ids[k]), gts[img_idx[k]])
    _, want = host.compute()
    table = port_devr.DfTable.build(df, ref_len, TOK2ID)
    pack = port_devr.scst_ref_pack(gts, df, table, TOK2ID, V, "cpu")  # L bucketed: pads are neutral
    assert pack["hi"].shape[2] % 32 == 0
    tbl = table.to("cpu")
    got = cider_reward_plain(t(ids), t(img_idx), {"hi": tbl.hi, "lo": tbl.lo, "val": tbl.val}, pack,
                             probe=table.probe, ref_len=table.ref_len).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_leave_one_out_baseline_matches_jax():
    sc = np.random.default_rng(3).random(12).astype(np.float32)
    want = np.asarray(devr.leave_one_out_baseline(jnp.asarray(sc), 4))
    np.testing.assert_array_equal(port_devr.leave_one_out_baseline(t(sc), 4).numpy(), want)
    with pytest.raises(ValueError):
        port_devr.leave_one_out_baseline(t(sc), 1)


# ------------------------------------------------------- weight bridge
def test_mask_freeze_masks_load_unfolded_as_binary_f32():
    jm, variables, port, _ = _mask_freeze()
    state = convert_jax_variables(variables, fold_masks=False)
    masks = {n: p for n, p in port.named_parameters() if n.endswith(".mask")}
    assert set(masks) == {n for n in state if n.endswith(".mask")} and len(masks) == 3 + 17 * KW["num_layers"]
    for name, m in masks.items():
        assert m.dtype == torch.float32 and set(m.unique().tolist()) == {0.0, 1.0}
        torch.testing.assert_close(m.detach(), state[name], rtol=0, atol=0)
    np.testing.assert_array_equal(port.generator.proj.mask.detach().numpy(),
                                  np.asarray(variables["masks"]["generator"]["proj"]["mask"]).T)


# ------------------------------------------------------ whole SCST step
CFG = dict(lr_scheduler="step", learning_rate=5e-5, optim="adam", grad_clip=0.1, scst_num_samples=3,
           scst_sample="random", scst_baseline="sample", scst_reward="device", max_seq_length=L + 1, seed=8)
BLEU = (0.0, 0.0, 0.0, 1.0)


def _scst_setup(reward_setup, dropout=0.0, **cfg):
    df_path, _, _, _ = reward_setup
    jm, variables, port, inputs = _mask_freeze(dropout)
    df, ref_len = load_df_pickle(df_path)
    rng = np.random.default_rng(7)
    gts = [[" ".join(f"w{i}" for i in rng.integers(4, V, rng.integers(3, 8))) for _ in range(4)] for _ in range(2)]
    table = port_devr.DfTable.build(df, ref_len, TOK2ID)
    config = dict(CFG, **cfg)
    params, masks = split_params(port)
    opt_w = port_optim.build_weight_optimizer(params.values(), config, port_optim.make_schedule(config))
    opt_m = port_optim.build_mask_optimizer(masks.values(), config, trainable=False)
    reward_fn = port_devr.make_reward_fn(table, bleu_weight=BLEU)
    step = make_scst_step(port, opt_w, opt_m, config, reward_fn)
    att, amask, boxes, _ = inputs
    batch = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes),
                 ref_pack=port_devr.scst_ref_pack(gts, df, table, TOK2ID, V, "cpu"))
    return jm, variables, port, inputs, (df, ref_len, gts, reward_fn), step, batch


def test_scst_step_matches_jax(reward_setup):
    """One two-phase SCST step (5 x 3 -> 2 x 3 here; step LR 5e-5, Adam,
    grad clip 0.1, frozen masks, dropout 0) against the JAX package's
    teacher-forced replay update (``bench.py:386-413``) on the same tokens:
    rewards, loss, every gradient, every param after the update."""
    jm, variables, port, inputs, (df, ref_len, gts, _), step, batch = _scst_setup(reward_setup)
    res = step.sample_fn(TrainState(), batch)
    sample = res["sample"]
    assert sample.shape == (2, 3, L) and sample.dtype == torch.int32
    before = launch_counts()
    state, loss, aux = step.grad_fn(TrainState(), batch, res)
    assert launch_counts() == before and state.step == 1

    # the JAX side: device reward, leave-one-out baseline, replay loss, Adam
    flat = sample.reshape(6, L).numpy()
    table_j = devr.DfTable.build(df, ref_len, TOK2ID)
    pack_j = devr.ref_pack_device(devr.build_ref_pack(gts, df, ref_len, TOK2ID, vocab_size=V))
    score = devr.make_reward_device_fn(table_j, cider_weight=1.0, bleu_weight=BLEU)
    sc = score(jnp.asarray(flat), jnp.repeat(jnp.arange(2), 3), table_j.device_arrays(), pack_j)
    rewards = sc - devr.leave_one_out_baseline(sc, 3)
    np.testing.assert_allclose(float(aux["avg_sample"]), float(jnp.mean(sc)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["avg_reward"]), float(jnp.mean(rewards)), rtol=1e-5, atol=1e-6)
    params, masks = variables["params"], variables["masks"]
    key = jax.random.PRNGKey(0)
    seqs_in = jnp.concatenate([jnp.full((6, 1), 2, jnp.int32), jnp.asarray(flat)], axis=1)

    def loss_fn(params, masks):
        v = {"params": params, "masks": masks}
        memory = jm.apply(v, *(jnp.asarray(a) for a in inputs[:3]), train=True, rngs={"dropout": key, "mask": key},
                          method="encode")
        lp = jm.apply(v, memory, seqs_in, True, method="decode_teacher_forced", rngs={"dropout": key})
        seq_lp = jnp.take_along_axis(lp, jnp.asarray(flat)[..., None], axis=2)[..., 0]
        return jax_losses.reward_loss(seq_lp, (jnp.asarray(flat) != 0).astype(jnp.float32), rewards)

    ref_loss, (gw, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1))(params, masks)
    opt_w = jax_optim.build_weight_optimizer(CFG, jax_optim.make_schedule(CFG))
    uw, _ = opt_w.update(gw, opt_w.init(params), params)
    new_params = optax.apply_updates(params, uw)
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
        # Adam moves a weight by ~lr sign(g): an entry whose g is within its
        # tolerance of 0 may move the other way; masks are frozen
        noisy = (g.abs() <= gtol).numpy()
        atol = 0.0 if name.endswith(".mask") else 1e-7 + 2 * lr * noisy
        err = np.abs(named[name].detach().numpy() - after[name].numpy())
        allowed = atol + 1e-6 * np.abs(after[name].numpy())
        assert (err <= allowed).all(), f"{name}: worst err/allowed {(err / allowed).max():.3g}"


def test_scst_step_runs_with_dropout_and_greedy_baseline(reward_setup):
    """The step with dropout on and the greedy baseline: the baseline is the
    greedy caption's reward, and a second step uses the next seed."""
    _, _, port, _, (_, _, _, reward_fn), step, batch = _scst_setup(reward_setup, dropout=0.1,
                                                                   scst_baseline="greedy")
    res = step.sample_fn(TrainState(), batch)
    assert res["greedy"].shape == (2, 1, L)
    state, loss, aux = step.grad_fn(TrainState(), batch, res)
    assert np.isfinite(float(loss)) and state.step == 1
    sc_greedy = reward_fn(res["greedy"].reshape(2, L), torch.arange(2, dtype=torch.int32), batch["ref_pack"])
    np.testing.assert_allclose(float(aux["avg_baseline"]), float(sc_greedy.mean()), rtol=1e-6, atol=1e-7)
    res2 = step.sample_fn(state, batch)
    assert not torch.equal(res2["sample"], res["sample"])
    state, _, aux2 = step(state, batch)
    assert state.step == 2 and np.isfinite(float(aux2["avg_baseline"]))


def test_scst_reward_defaults_to_host():
    """A config without ``scst_reward`` asks for the JAX package's default,
    the host reward (``opts.py:72``), which the port does not have yet: the
    step is refused and the device reward is never built or called."""
    calls = []
    model = get_model("relation_transformer_prune")(**KW, device="cpu",
                                                    mask_cfg=MaskConfig("mask_freeze", keep_masks=True))
    cfg = {k: v for k, v in CFG.items() if k != "scst_reward"}
    with pytest.raises(NotImplementedError, match="host reward"):
        make_scst_step(model, None, None, cfg, lambda *args: calls.append(args))
    assert calls == []


def test_unported_scst_paths_raise(reward_setup):
    """The host reward and the pipelined and fused steps raise; beam-sample
    SCST (ported) samples the beams of the train-mode beam search, which at
    dropout 0 are the JAX package's, and its step runs; supermask SCST
    (ported) runs: one step with dropout on updates weights and masks."""
    with pytest.raises(NotImplementedError, match="later slice"):
        _scst_setup(reward_setup, scst_reward="host")
    jm, variables, port, inputs, _, step, batch = _scst_setup(reward_setup, scst_sample="beam_search")
    res = step.sample_fn(TrainState(), batch)
    att, amask, boxes, _ = inputs
    memory = jm.apply(variables, jnp.asarray(att), jnp.asarray(amask), jnp.asarray(boxes), method="encode")
    ref_seq, _ = jax_generate(jm, variables, memory, {"beam_size": 3, "max_seq_length": L, "decode_train": True},
                              rng=jax.random.PRNGKey(0))
    np.testing.assert_array_equal(res["sample"].numpy(), np.asarray(ref_seq))
    state, loss, _ = step.grad_fn(TrainState(), batch, res)
    assert state.step == 1 and np.isfinite(float(loss))
    _, _, _, _, (_, _, _, reward_fn), _, batch = _scst_setup(reward_setup)
    model = get_model("relation_transformer_prune")(**KW, dropout_rate=0.1, drop_prob_src=0.1, device="cpu",
                                                    mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    params, masks = split_params(model)
    before = {n: m.detach().clone() for n, m in masks.items()}
    opt_w = port_optim.build_weight_optimizer(params.values(), CFG, port_optim.make_schedule(CFG))
    opt_m = port_optim.build_mask_optimizer(masks.values(), CFG, trainable=True)
    state, loss, _ = make_scst_step(model, opt_w, opt_m, CFG, reward_fn)(TrainState(), batch)
    assert state.step == 1 and np.isfinite(float(loss))
    assert all(not torch.equal(m, before[n]) for n, m in masks.items())
    for fn in (make_scst_pipelined_step, make_scst_fused_step):
        with pytest.raises(NotImplementedError, match="later slice"):
            fn()
    with pytest.raises(TypeError, match="RadixSpec"):  # the radix regroup is ported; it takes its spec, not a function
        port_devr.make_reward_fn(None, regroup=lambda ids: ids)

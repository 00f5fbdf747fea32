"""Train-mode parity of the PyTorch port against the JAX package on the CPU:
the straight-through estimators, the plain versions behind kernels K5
(supermask weight), K6 (residual + RefLayerNorm) and K1/K7 (box attention
with its backward), the LR schedules, the weight bridge's unfolded masks, and
one whole supermask XE step (loss, gradients, updated params and masks).

Random streams cannot be shared between the frameworks, so the JAX side's
mask uniforms are recorded (``sample_mask`` patched, call by call) and
replayed into the port in its own call order, and dropout is 0."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sparse_caption_tpu.ops.masked as jax_masked
from _torch_port_common import D, HEADS, KW, R, jax_variables, make_inputs, t, to_numpy
from sparse_caption_tpu.engine import losses as jax_losses
from sparse_caption_tpu.engine import optim as jax_optim
from sparse_caption_tpu.models import layers as jl
from sparse_caption_tpu.models.relation_transformer import RelationTransformer as JaxORT
from sparse_caption_tpu.ops import ste as jax_ste
from sparse_caption_tpu.pruning.engine import compute_sparsity_loss as jax_sparsity_loss
from sparse_caption_tpu_torch.engine import optim as port_optim
from sparse_caption_tpu_torch.engine.training import TrainState, make_xe_step
from sparse_caption_tpu_torch.kernels.add_ref_layernorm import add_ref_layernorm
from sparse_caption_tpu_torch.kernels.box_attention_bwd import box_attention_train
from sparse_caption_tpu_torch.kernels.supermask import supermask_weight
from sparse_caption_tpu_torch.models import get_model
from sparse_caption_tpu_torch.ops import ste as port_ste
from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedLinear, split_params
from sparse_caption_tpu_torch.ops.rng import TrainRandom
from sparse_caption_tpu_torch.utils.convert_jax import convert_jax_variables, load_jax_variables

KEY = jax.random.PRNGKey(0)
TWIN_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TWIN_TOL))


def _grads(out, inputs, cot):
    return torch.autograd.grad(out, inputs, cot)


# ------------------------------------------------------------------ STE
@pytest.mark.parametrize("bypass", [False, True])
@pytest.mark.parametrize("fn", ["bernoulli", "rounding"])
def test_ste_matches_jax(fn, bypass):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, size=(6, 7)).astype(np.float32)
    g = rng.normal(size=(6, 7)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    if fn == "bernoulli":
        jfn = functools.partial(jax_ste.bernoulli_sample_sigmoid, key=key, bypass_sigmoid_grad=bypass)
        u = t(jax.random.uniform(key, logits.shape))
        pfn = functools.partial(port_ste.bernoulli_sample_sigmoid, u=u, bypass_sigmoid_grad=bypass)
    else:
        jfn = functools.partial(jax_ste.rounding_sigmoid, bypass_sigmoid_grad=bypass)
        pfn = functools.partial(port_ste.rounding_sigmoid, bypass_sigmoid_grad=bypass)
    ref, vjp = jax.vjp(jfn, jnp.asarray(logits))
    m = t(logits).requires_grad_()
    out = pfn(m)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))  # the same sample, bit for bit
    assert 0 < float(out.detach().mean()) < 1
    _close(_grads(out, m, t(g))[0], vjp(jnp.asarray(g))[0], rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- K5 twin
@pytest.mark.parametrize("mode,bypass", [("sample", False), ("sample", True), ("round", False), ("multiply", False)])
def test_k5_supermask_twin_matches_jax_masked(mode, bypass):
    """K5's plain version vs ``_masked`` of the JAX package: forward and the
    gradients of weight and mask."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(5, 9)).astype(np.float32)
    m = (rng.normal(0, 2, size=(5, 9)) if mode != "multiply" else rng.uniform(size=(5, 9)) < 0.5).astype(np.float32)
    g = rng.normal(size=(5, 9)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    cfg = jax_masked.MaskConfig("supermask" if mode != "multiply" else "mag_blind", bypass_sigmoid_grad=bypass)

    def jfn(kernel, mask):
        return (kernel * jax_masked.sample_mask(mask, cfg, mode == "sample", key)).astype(kernel.dtype)

    ref, vjp = jax.vjp(jfn, jnp.asarray(w), jnp.asarray(m))
    pw, pm = t(w).requires_grad_(), t(m).requires_grad_()
    u = t(jax.random.uniform(key, m.shape)) if mode == "sample" else None
    out = supermask_weight(pw, pm, u, mode, bypass)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    for port_g, ref_g in zip(_grads(out, (pw, pm), t(g)), vjp(jnp.asarray(g))):
        _close(port_g, ref_g, rtol=1e-6, atol=1e-6)


def test_k5_wrapper_checks_inputs():
    w = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        supermask_weight(w, torch.zeros(4, 3), None, "sample")
    with pytest.raises(TypeError):
        supermask_weight(w, torch.zeros(4, 3, dtype=torch.float64), torch.zeros(4, 3), "sample")
    with pytest.raises(ValueError):
        supermask_weight(w, torch.zeros(4, 3), torch.zeros(4, 3), "round")


# ------------------------------------------------------------- K6 twin
@pytest.mark.parametrize("with_y", [True, False])
def test_k6_add_ref_layernorm_twin_matches_jax(with_y):
    """K6's plain version vs ``x + y`` then the JAX RefLayerNorm: both outputs
    and the gradients of x, y, scale and bias."""
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 2.0, size=(3, 4, D)).astype(np.float32)
    y = rng.normal(size=(3, 4, D)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, size=D).astype(np.float32)
    b = rng.normal(size=D).astype(np.float32)
    gs, gn = rng.normal(size=(2, 3, 4, D)).astype(np.float32)
    norm = jl.RefLayerNorm()

    def jfn(x, y, a, b):
        s = x + y if with_y else x
        n = norm.apply({"params": {"scale": a, "bias": b}}, s)
        return (s, n) if with_y else n

    jargs = tuple(jnp.asarray(v) for v in (x, y, a, b))
    ref, vjp = jax.vjp(jfn, *jargs)
    px, py, pa, pb = (t(v).requires_grad_() for v in (x, y, a, b))
    out = add_ref_layernorm(px, py if with_y else None, pa, pb)
    if with_y:
        _close(out[0], ref[0])
        _close(out[1], ref[1])
        port_g = _grads(out, (px, py, pa, pb), (t(gs), t(gn)))
        ref_g = vjp((jnp.asarray(gs), jnp.asarray(gn)))
    else:
        _close(out, ref)
        port_g = _grads(out, (px, pa, pb), t(gn))
        ref_g = [g for i, g in enumerate(vjp(jnp.asarray(gn))) if i != 1]
    for p, r in zip(port_g, ref_g):
        _close(p, r)


def test_k6_dropout_keep_mask_scales_the_sublayer():
    rng = np.random.default_rng(3)
    x, y = t(rng.normal(size=(2, 3, D)).astype(np.float32)), t(rng.normal(size=(2, 3, D)).astype(np.float32))
    keep = t(rng.uniform(size=(2, 3, D)) < 0.9)
    a, b = torch.ones(D), torch.zeros(D)
    s, _ = add_ref_layernorm(x, y, a, b, keep, 0.9)
    torch.testing.assert_close(s, x + torch.where(keep, y / 0.9, torch.zeros_like(y)))
    with pytest.raises(ValueError):
        add_ref_layernorm(x, None, a, b, keep, 0.9)


# ---------------------------------------------------------- K1/K7 twin
@pytest.mark.parametrize("with_dropout", [False, True])
def test_k7_box_attention_twin_gradients_match_jax(with_dropout):
    """``box_attention_train``'s plain version vs the JAX geometry + wg +
    log-bias + attention (a fixed keep-mask standing in for nn.Dropout): the
    output and the gradients of q, k, v, wg kernel and wg bias."""
    rng = np.random.default_rng(5)
    b, h, dk = 2, HEADS, 8
    q, k, v, go = (rng.normal(size=(b, h, R, dk)).astype(np.float32) for _ in range(4))
    xy = rng.uniform(0, 400, size=(b, R, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 200, size=(b, R, 2))], -1).astype(np.float32)
    # w_g = relu(geo . wg + 1) in [0.1, 1.9]: away from the clamp's kink
    wg_k = np.zeros((64, h), np.float32)
    for hh in range(h):
        wg_k[rng.choice(64, 4, replace=False), hh] = rng.choice([-0.225, 0.225], 4)
    wg_b = np.ones(h, np.float32)
    mask = np.ones((b, R), bool)
    mask[1, -2:] = False
    keep = rng.uniform(size=(b, h, R, R)) < 0.8 if with_dropout else None
    kp = 0.8 if with_dropout else 1.0

    def jfn(q, k, v, wg_k, wg_b):
        geo = jl.box_relational_embedding(jnp.asarray(boxes))
        w_g = jax.nn.relu(geo @ wg_k + wg_b)
        log_wg = jnp.log(jnp.maximum(w_g, 1e-6)).transpose(0, 3, 1, 2)
        drop = None if keep is None else (lambda p: jnp.where(keep, p / kp, 0.0))
        return jl.scaled_dot_attention(q, k, v, mask=jnp.asarray(mask)[:, None, None, :], bias=log_wg, dropout=drop)

    ref, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v, wg_k, wg_b)))
    pq, pk, pv = (t(a).requires_grad_() for a in (q, k, v))
    pw, pb = t(wg_k.T.copy()).requires_grad_(), t(wg_b).requires_grad_()
    out = box_attention_train(pq, pk, pv, t(boxes), pw, pb, t(mask), None if keep is None else t(keep), kp)
    _close(out, ref)
    port_g = _grads(out, (pq, pk, pv, pw, pb), t(go))
    ref_g = list(vjp(jnp.asarray(go)))
    ref_g[3] = ref_g[3].T
    for p, r in zip(port_g, ref_g):  # 1e-5 of each gradient's scale: sums over B * R * R pairs
        _close(p, r, rtol=1e-5, atol=1e-5 * float(jnp.abs(r).max()))
    assert float(port_g[3].abs().max()) > 1e-3  # the wg gradient is real


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("cfg", [
    dict(lr_scheduler="noam", d_model=512, noamopt_warmup=10000, noamopt_factor=1.0),
    dict(lr_scheduler="step", learning_rate=5e-4, learning_rate_decay_start=0, learning_rate_decay_every=3,
         learning_rate_decay_rate=0.8),
    dict(lr_scheduler="cosine", learning_rate=0.01, learning_rate_min=1e-5, max_train_step=1000),
])
def test_schedules_match_jax(cfg):
    jsched, psched = jax_optim.make_schedule(cfg, steps_per_epoch=7), port_optim.make_schedule(cfg, steps_per_epoch=7)
    for step in (0, 1, 6, 7, 29, 500, 9999, 20000):
        np.testing.assert_allclose(psched(step), float(jsched(jnp.asarray(step, jnp.int32))), rtol=1e-6)


@pytest.mark.parametrize("optim", ["sgd", "sgdm", "sgdmom"])
def test_sgd_family_matches_optax(optim):
    """Two updates of ``sgd``, ``sgdm`` and ``sgdmom`` (``torch.optim.SGD``,
    nesterov for sgdmom) against the JAX package's optax chain on the same
    params and gradients: the value clip at 0.1 (gradients up to 0.5 here),
    coupled L2 weight decay 1e-2 after the clip, momentum 0.9, a step
    schedule that halves the LR from the second update on; so momentum and
    nesterov act past their first step. Params within 1e-6 relative (+1e-7):
    f32 rounding of the same operations."""
    cfg = dict(optim=optim, lr_scheduler="step", learning_rate=0.1, learning_rate_decay_start=0,
               learning_rate_decay_every=1, learning_rate_decay_rate=0.5, weight_decay=1e-2, grad_clip=0.1,
               optim_alpha=0.9)
    rng = np.random.default_rng(20)
    params = {"w": rng.normal(size=(4, 5)).astype(np.float32), "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 0.2, size=v.shape).astype(np.float32) for k, v in params.items()} for _ in range(2)]
    tx = jax_optim.build_weight_optimizer(cfg, jax_optim.make_schedule(cfg, steps_per_epoch=1))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    ported = {k: t(v).requires_grad_() for k, v in params.items()}
    opt = port_optim.build_weight_optimizer(ported.values(), cfg, port_optim.make_schedule(cfg, steps_per_epoch=1))
    for step, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in ported.items():
            p.grad = t(g[k])
        opt.step(step)
        for k, p in ported.items():
            _close(p, jparams[k], rtol=1e-6, atol=1e-7)
            _close(p.grad, g[k], rtol=0, atol=0)  # the raw gradient stays in .grad


def test_unported_optimizers_raise():
    p = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(NotImplementedError):
        port_optim.build_weight_optimizer(p, dict(lr_scheduler="step", optim="rmsprop"), lambda s: 1e-3)


# ------------------------------------------------------- weight bridge
def test_convert_unfolded_masks_round_trip():
    inputs = make_inputs()
    jm = JaxORT(**KW, mask_cfg=jax_masked.MaskConfig("supermask", 5.0))
    variables = jax_variables(jm, inputs, mask_seed=9)
    state = convert_jax_variables(variables, fold_masks=False)
    flat = jax.tree_util.tree_flatten_with_path(variables["masks"])[0]
    # att_embed, 7 per box layer (wg included), 10 per decoder layer, lut, generator proj
    assert len(flat) == sum(name.endswith(".mask") for name in state) == 3 + 17 * KW["num_layers"]
    for path, m in flat:
        names = [p.key for p in path]
        got = state[".".join(n.replace("_layers_", "_layers.") for n in names[:-1]) + ".mask"].numpy()
        np.testing.assert_array_equal(got if names[-2] == "lut" else got.T, m)  # Dense masks transpose
    model = get_model("relation_transformer_prune")(**KW, mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True),
                                                    device="cpu")
    load_jax_variables(model, variables)  # strict
    torch.testing.assert_close(model.generator.proj.mask, t(variables["masks"]["generator"]["proj"]["mask"]).T)


# ---------------------------------------------------- whole XE step
class ReplayRandom(TrainRandom):
    """Hands each masked layer the next recorded JAX uniforms (in the JAX
    package's (in, out) kernel layout, transposed for a Linear)."""

    def __init__(self, recorded):
        super().__init__(torch.Generator())
        self.recorded = list(recorded)

    def mask_uniform(self, layer, shape, device):
        u = self.recorded.pop(0)
        u = np.ascontiguousarray(u.T if isinstance(layer, MaskedLinear) else u)
        assert tuple(u.shape) == tuple(shape), (u.shape, shape)
        return t(u)

    def keep_mask(self, shape, keep_prob, device):
        raise AssertionError("dropout is 0 in this test")


CFG = dict(lr_scheduler="noam", d_model=D, noamopt_warmup=10000, noamopt_factor=2e4, grad_clip=0.1, optim="adam",
           max_train_step=10, prune_sparsity_target=0.8)
SP_TARGET, SP_WEIGHT = 0.8, 7.5  # max(5, 1.5 / (1 - 0.8))
MASK_LR, MASK_EPS = 100.0, 1e-2  # the mask optimizer's defaults


def _jax_xe_steps(bypass, n_steps, monkeypatch, freeze_scope=None):
    inputs = make_inputs()
    att, amask, boxes, seqs = (jnp.asarray(a) for a in inputs)
    seq_masks = jnp.asarray((np.asarray(inputs[3]) != 0).astype(np.float32))
    jm = JaxORT(**KW, dropout_rate=0.0, drop_prob_src=0.0,
                mask_cfg=jax_masked.MaskConfig("supermask", 5.0, bypass_sigmoid_grad=bypass))
    variables = jax_variables(jm, inputs, mask_seed=11)
    params, masks = variables["params"], variables["masks"]
    sched = jax_optim.make_schedule(CFG)
    opt_w, opt_m = jax_optim.build_weight_optimizer(CFG, sched), jax_optim.build_mask_optimizer(CFG, True)
    ow, om = opt_w.init(params), opt_m.init(masks)
    recorded = []
    real_sample = jax_masked.sample_mask

    def recording_sample(mask, cfg, train, rng_key):
        if cfg.is_supermask and train:
            recorded[-1].append(np.asarray(jax.random.uniform(rng_key, mask.shape)))
        return real_sample(mask, cfg, train, rng_key)

    monkeypatch.setattr(jax_masked, "sample_mask", recording_sample)
    steps = []
    for step in range(n_steps):
        recorded.append([])

        def loss_fn(params, masks):
            lp = jm.apply({"params": params, "masks": masks}, att, amask, seqs, boxes, train=True,
                          rngs={"dropout": KEY, "mask": jax.random.PRNGKey(100 + step)})
            cap = jax_losses.language_model_loss(lp, seqs[:, 1:], seq_masks[:, 1:])
            sp, aux = jax_sparsity_loss(masks, SP_TARGET, SP_WEIGHT, step, CFG["max_train_step"], freeze_scope)
            return cap + sp, dict(aux, caption_loss=cap)

        (loss, aux), (gw, gm) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(params, masks)
        uw, ow = opt_w.update(gw, ow, params)
        um, om = opt_m.update(gm, om, masks)
        params, masks = optax.apply_updates(params, uw), optax.apply_updates(masks, um)
        steps.append(dict(loss=float(loss), aux={k: float(v) for k, v in aux.items()},
                          grads=convert_jax_variables(to_numpy({"params": gw, "masks": gm}), fold_masks=False),
                          state=convert_jax_variables(to_numpy({"params": params, "masks": masks}), fold_masks=False),
                          u=recorded[-1]))
    return variables, inputs, steps


@pytest.mark.parametrize("bypass,n_steps", [(False, 2), (True, 1)])
def test_xe_step_matches_jax(bypass, n_steps, monkeypatch):
    """Loss, sparsity aux, every gradient, and every param and mask after each
    update. Tolerances: loss 1e-5 relative; a gradient within 1e-5 of its
    tensor's largest entry (summation order over a few hundred terms) plus
    1e-7 of the largest gradient of all (the key projection's bias has a
    gradient of 0 in exact arithmetic, which both sides give as rounding
    noise of that size);
    params within 1e-6 + 1e-5 |p| (noam lr 3.5e-3 here: an update is about
    lr * sign(g), so only an entry whose |g| is within its tolerance of 0 may
    move the other way: those get 2 lr per update more); masks within 1e-5 |m| plus 1e4 times their
    gradient's tolerance (Adam's first update is -lr g / (|g| + eps) with lr
    100 and eps 1e-2, whose slope in g is at most lr / eps = 1e4)."""
    variables, inputs, steps = _jax_xe_steps(bypass, n_steps, monkeypatch)
    _port_xe_steps_match(variables, inputs, steps, bypass, CFG)


def _port_xe_steps_match(variables, inputs, steps, bypass, cfg):
    """The port's ``make_xe_step`` from the same variables and uniforms, held
    against the recorded JAX steps (tolerances: ``test_xe_step_matches_jax``)."""
    n_steps = len(steps)
    model = get_model("relation_transformer_prune")(
        **KW, dropout_rate=0.0, drop_prob_src=0.0, device="cpu",
        mask_cfg=MaskConfig("supermask", 5.0, bypass_sigmoid_grad=bypass, keep_masks=True))
    load_jax_variables(model, variables)
    params, masks = split_params(model)
    opt_w = port_optim.build_weight_optimizer(params.values(), cfg, port_optim.make_schedule(cfg))
    opt_m = port_optim.build_mask_optimizer(masks.values(), cfg, trainable=True)
    xe_step = make_xe_step(model, opt_w, opt_m, cfg)
    att, amask, boxes, seqs = inputs
    batch = dict(att_feats=t(att), att_masks=t(amask), boxes=t(boxes), seqs=t(seqs).long(),
                 seq_masks=t((seqs != 0).astype(np.float32)))
    state = TrainState()
    named = dict(model.named_parameters())
    sched = port_optim.make_schedule(cfg)
    noisy = {}  # weight entries whose gradient was within its tolerance of 0 at some step
    for step_i, ref in enumerate(steps):
        rng = ReplayRandom(ref["u"])
        state, loss, aux = xe_step(state, batch, rng)
        assert not rng.recorded  # every JAX draw consumed, in order
        np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
        for k, v in ref["aux"].items():
            np.testing.assert_allclose(float(aux[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert set(ref["grads"]) == set(named)
        top = max(float(g.abs().max()) for g in ref["grads"].values())
        gtol = {name: 1e-5 * float(g.abs().max()) + 1e-7 * top for name, g in ref["grads"].items()}
        for name, g in ref["grads"].items():
            _close(named[name].grad, g, rtol=0, atol=gtol[name], err_msg=name)
            noisy[name] = noisy.get(name, False) | (g.abs() <= gtol[name]).numpy()
        lr_sum = sum(sched(i) for i in range(step_i + 1))
        for name, p in ref["state"].items():
            if name in masks:
                atol = MASK_LR / MASK_EPS * gtol[name]
            else:  # Adam moves an entry by ~lr sign(g): a g at the noise floor may go either way
                atol = 1e-6 + 2 * lr_sum * noisy[name]
            err = np.abs(named[name].detach().numpy() - p.numpy())
            allowed = atol + 1e-5 * np.abs(p.numpy())
            assert (err <= allowed).all(), f"{name}: worst err/allowed {(err / allowed).max():.3g}"
    assert state.step == n_steps
    if n_steps > 1:  # the sparsity term really pushed the masks in step 2
        assert ref["aux"]["anneal_rate"] < 1


@pytest.mark.parametrize("scope,n_active", [("decoder_layers_0", 27), ("box_encoder_layers_1/self_attn", 32)])
def test_xe_step_with_freeze_scope_matches_jax(scope, n_active, monkeypatch):
    """``prune_mask_freeze_scope`` prefixes match flax path strings, as in the
    JAX package's XE step (``engine/training.py`` passes them to
    ``compute_sparsity_loss``): a scope that names a layer index or uses ``/``
    leaves the same masks active (27 and 32 of 37 in this 2-layer ORT), and
    two steps (the second with the sparsity term's gradient on) agree in
    loss, sparsity aux, gradients, params and masks."""
    from sparse_caption_tpu.pruning.engine import active_paths as jax_active_paths
    from sparse_caption_tpu_torch.pruning.engine import active_paths

    variables, inputs, steps = _jax_xe_steps(False, 2, monkeypatch, [scope])
    jax_active = jax_active_paths(variables["masks"], [scope])
    model = get_model("relation_transformer_prune")(**KW, mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True),
                                                    device="cpu")
    load_jax_variables(model, variables)
    assert active_paths(split_params(model)[1], [scope]) == jax_active
    assert len(jax_active) == n_active and len(split_params(model)[1]) == 37
    _port_xe_steps_match(variables, inputs, steps, False, dict(CFG, prune_mask_freeze_scope=scope))

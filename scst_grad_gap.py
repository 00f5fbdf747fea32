#!/usr/bin/env python3
"""Where the card-vs-CPU gap of a supermask ORT's SCST gradient comes from.

The gradient pass of supermask SCST (``engine/training.py scan_log_probs``)
runs the paper-width ORT's decode again with gradients; ``chip_smoke.py``
holds one such step card against CPU norm-wise. This script measures the
gap two ways, on the gradient of the sampled tokens' summed log-probs (and
of the leave-one-out-weighted sum SCST takes):

    python3 scst_grad_gap.py card   # on an H100: card vs CPU, the kernels as they are,
                                    # then every kernel family swapped for its plain version on the card
    python3 scst_grad_gap.py ulp    # on the CPU: the same gradient before and after every weight
                                    # moves by one ulp (how ill-conditioned the instance is)
    python3 scst_grad_gap.py cause  # on an H100: the supermask sample flips of every keyed draw, the
                                    # card and the CPU in f32 against the CPU in f64, at decode lengths
                                    # 1, 4 and 17, the CPU with its own samples and with the card's

Each line gives the norm-wise relative difference of every parameter's
gradient (median, 90th percentile) and, for ``card``, the five worst tensors
in ``chip_smoke.py``'s norm-wise units (<= 1 passes). Weights, masks and
inputs are random from fixed seeds.

``cause`` counts, in every keyed supermask set the card draws
(``chip_smoke.keyed_flip_counts``), the samples [u < sigmoid(m)] that the
card's and the CPU's sigmoids decide apart (a u on the 2^-24 grid between
two sigmoids one ulp apart), and compares the card's gradient with the
CPU's in f32 with its own samples, with the card's samples
(``chip_smoke.card_sample_bits``), and with the CPU's in f64 (the card's
samples; every parameter but the mask logits in f64, the kernels' plain
versions called directly). A handful of flipped weights in 571M samples
moves the 17-step decode's gradient by far more than rounding does; with
one set of samples the card and both CPU references agree to rounding.
"""

from __future__ import annotations

import copy
import sys

import torch

PAPER = dict(vocab_size=10000, d_model=512, dim_feedforward=2048, num_layers=6, num_heads=8, att_feat_size=2048,
             max_seq_length=17)
LOO = torch.tensor([0.4566, -0.2283, -0.2283, 0.4566, -0.2283, -0.2283])  # leave-one-out rewards of 2 x 3 samples


def build(device: str, layers: int, widths=None):
    """A supermask ORT at paper width (or ``widths``), mask logits N(0, 1), and a 2-image batch."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params

    cfg = dict(PAPER, num_layers=layers, **(widths or {}))
    g = torch.Generator(device=device).manual_seed(15)
    model = get_model("relation_transformer_prune")(**cfg, device=device, generator=g,
                                                    mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    with torch.no_grad():
        for m in split_params(model)[1].values():
            m.copy_(torch.randn(m.shape, generator=g, device=device))
    att = torch.randn(2, 36, cfg["att_feat_size"], generator=g, device=device)
    amask = torch.ones(2, 36, device=device)
    amask[1, 30:] = 0
    xy = torch.rand(2, 36, 2, generator=g, device=device) * 400
    boxes = torch.cat([xy, xy + torch.rand(2, 36, 2, generator=g, device=device) * 190 + 10], -1)
    return model, (att, amask, boxes)


def sample(model, batch):
    """3 train-mode samples per image (keyed streams), (6, 17)."""
    from sparse_caption_tpu_torch.decoding import generate
    from sparse_caption_tpu_torch.ops.rng import KeyedStream

    with torch.no_grad():
        memory = model.encode(*batch, train=True, rng=KeyedStream(11))
        opt = {"num_random_sample": 3, "beam_size": 0, "max_seq_length": 17, "decode_train": True}
        return generate(model, memory, opt, rng=12)[0].reshape(6, -1)


def grads(model, batch, flat, weights):
    """Every parameter's gradient of -sum(weights x log-probs) / tokens through the decode scan."""
    from sparse_caption_tpu_torch.engine.training import scan_log_probs
    from sparse_caption_tpu_torch.ops.rng import KeyedStream

    dev = next(model.parameters()).device
    model.zero_grad()
    memory = model.encode(*(x.to(dev) for x in batch), train=True, rng=KeyedStream(11))
    lp = scan_log_probs(model, memory, flat.to(dev), 12)
    valid = (flat.to(dev) != 0).float()
    (-(lp * valid * weights.to(dev)[:, None]).sum() / valid.sum()).backward()
    return {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}


def spread(got, ref) -> str:
    rel = sorted(((got[n] - ref[n]).norm() / ref[n].norm()).item() for n in ref if ref[n].norm() > 0)
    return f"norm-wise relative difference median {rel[len(rel) // 2]:.2e}, 90th {rel[int(0.9 * len(rel))]:.2e}"


def check_units(got, ref) -> str:
    """The five worst tensors in chip_smoke.py's units: |d| / (1e-2 |g| + 1e-6 top sqrt(n))."""
    top = max(g.abs().max().item() for g in ref.values())
    ratio = {n: ((got[n] - ref[n]).norm() / (1e-2 * ref[n].norm() + 1e-6 * top * ref[n].numel() ** 0.5)).item()
             for n in ref}
    return ", ".join(f"{n} {ratio[n]:.3f}" for n in sorted(ratio, key=ratio.get)[-5:][::-1])


def swaps() -> dict:
    """Kernel families and their plain versions, patched where the port calls them."""
    import sparse_caption_tpu_torch.engine.training as tr
    import sparse_caption_tpu_torch.models.layers as layers
    import sparse_caption_tpu_torch.ops.masked as masked
    import sparse_caption_tpu_torch.ops.rng as rng
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
    from sparse_caption_tpu_torch.kernels import supermask as k5
    from sparse_caption_tpu_torch.kernels.add_ref_layernorm import add_ref_layernorm_plain
    from sparse_caption_tpu_torch.kernels.box_attention import box_attention_plain
    from sparse_caption_tpu_torch.kernels.keyed_dropout import keyed_dropout_plain
    from sparse_caption_tpu_torch.kernels.vocab_log_softmax import vocab_log_softmax_plain

    def plain_set(ws, ms, us=None, mode="sample", bypass=False):
        return [k5.supermask_weight_plain(w, m, None if us is None else us[i], mode, bypass)
                for i, (w, m) in enumerate(zip(ws, ms))]

    k1 = [(layers, "box_attention_train", box_attention_plain)]
    rest = [(layers, "add_ref_layernorm", add_ref_layernorm_plain),
            (k2, "ancestry_self_attention", k2.ancestry_self_attention_plain),
            (k2, "ancestry_self_attention_backward", k2.ancestry_self_attention_backward_plain),
            (k3, "_forward", lambda q, mk, mv, mask: k3.grouped_cross_attention_plain(q, mk, mv, mask)),
            (k3, "grouped_cross_attention_backward", k3.grouped_cross_attention_backward_plain),
            (tr, "vocab_log_softmax", vocab_log_softmax_plain), (rng, "keyed_dropout", keyed_dropout_plain),
            (masked, "supermask_weights", plain_set),
            (masked, "supermask_weight", lambda w, m, u=None, mode="sample", bypass=False:
             plain_set([w], [m], None if u is None else [u], mode, bypass)[0])]
    return {"none": [], "all": k1 + rest, "k1": k1}


def card() -> None:
    from sparse_caption_tpu_torch.kernels import build_all

    if not torch.cuda.is_available():
        sys.exit("scst_grad_gap.py card: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    model_gpu, batch = build("cuda", PAPER["num_layers"])
    model_cpu = copy.deepcopy(model_gpu).to("cpu")
    batch_cpu = tuple(x.cpu() for x in batch)
    flat = sample(model_cpu, batch_cpu)
    ref = {tag: grads(model_cpu, batch_cpu, flat, w) for tag, w in (("loo", LOO), ("sum", torch.ones(6)))}
    for name, patches in swaps().items():
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
        for mod, attr, fn in patches:
            setattr(mod, attr, fn)
        for tag, w in (("loo", LOO), ("sum", torch.ones(6))):
            got = grads(model_gpu, batch, flat, w)
            print(f"[card] plain on the card: {name}; {tag}: {spread(got, ref[tag])}; worst in chip_smoke units: "
                  f"{check_units(got, ref[tag])}", flush=True)
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    print(torch.cuda.get_device_name(0))


def ulp() -> None:
    from sparse_caption_tpu_torch.ops.masked import split_params

    for layers in (2, PAPER["num_layers"]):
        model, batch = build("cpu", layers)
        flat = sample(model, batch)
        before = grads(model, batch, flat, torch.ones(6))
        g = torch.Generator().manual_seed(1)
        with torch.no_grad():  # every weight one ulp up or down; masks, and so the samples, unchanged
            for p in split_params(model)[0].values():
                p.mul_(1 + 2.0 ** -23 * (torch.randint(0, 2, p.shape, generator=g) * 2 - 1))
        print(f"[ulp] {layers} layers, CPU, every weight moved by one ulp: "
              f"{spread(grads(model, batch, flat, torch.ones(6)), before)}", flush=True)


def f64_copy(model):
    """A CPU copy of ``model`` with every parameter but the masks in f64 (K5's
    plain version takes f32 mask logits; its product then comes out in f64)."""
    from sparse_caption_tpu_torch.ops.masked import split_params

    out = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        for p in split_params(out)[0].values():
            p.data = p.data.double()
    return out


def f64_patches() -> list:
    """The plain versions on f64 tensors: the float checks widened, every
    kernel family's plain version called directly (``swaps``), the f32-only
    backward checks of K2 / K3 lifted, and the log-softmax kept in f64."""
    import sparse_caption_tpu_torch.engine.training as tr
    from sparse_caption_tpu_torch.kernels import _checks
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3

    return swaps()["all"] + [
        (_checks, "FLOATS", (torch.float32, torch.bfloat16, torch.float64)),
        (k2, "check_backward_supported", lambda *a: None), (k3, "check_backward_supported", lambda *a: None),
        (tr, "vocab_log_softmax", lambda x, out_dtype=None: torch.log_softmax(x, dim=-1))]


def patched(patches, fn, *args):
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, value in patches:
            setattr(mod, attr, value)
        return fn(*args)
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def worst(got, ref) -> tuple:
    """The worst tensor in chip_smoke.py's norm-wise units (<= 1 passes)."""
    top = max(g.abs().max().item() for g in ref.values())
    ratio = {n: ((got[n].double() - ref[n].double()).norm()
                 / (1e-2 * ref[n].double().norm() + 1e-6 * top * ref[n].numel() ** 0.5)).item() for n in ref}
    name = max(ratio, key=ratio.get)
    return ratio[name], name


def cause(device: str = "cuda", layers: int = PAPER["num_layers"], widths=None) -> None:
    """The gap's cause: flips of the supermask samples, or rounding. For each
    decode length, the gradient of the leave-one-out-weighted log-probs on the
    card (its keyed sets' flips counted), on the CPU in f32 with its own
    samples and with the card's, and on the CPU in f64 with the card's."""
    import chip_smoke as cs
    from sparse_caption_tpu_torch.kernels import build_all

    if device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("scst_grad_gap.py cause: CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        build_all()
    model_gpu, batch = build(device, layers, widths)
    model_cpu, model_64 = copy.deepcopy(model_gpu).to("cpu"), f64_copy(model_gpu)
    batch_cpu = tuple(x.cpu() for x in batch)
    batch_64 = (batch_cpu[0].double(),) + batch_cpu[1:]
    flat = sample(model_cpu, batch_cpu)
    card_p, card_p64 = cs.card_sigmoids(model_gpu, model_cpu), cs.card_sigmoids(model_gpu, model_64)
    for steps in (1, 4, PAPER["max_seq_length"]):
        part = flat[:, :steps].contiguous()
        counts = []
        with cs.keyed_flip_counts(counts):
            g_card = grads(model_gpu, batch, part, LOO)
        flips = sum(f for _, f, _ in counts)
        g_own = grads(model_cpu, batch_cpu, part, LOO)
        with cs.card_sample_bits(card_p):
            g_shared = grads(model_cpu, batch_cpu, part, LOO)
        with cs.card_sample_bits(card_p64):
            g_64 = patched(f64_patches(), grads, model_64, batch_64, part, LOO)
        print(f"[cause] {steps} decode steps: {len(counts)} keyed sets on the card, flips (t: count) "
              f"{', '.join(f'{t}: {f}' for t, f, _ in counts)}, {flips} of {sum(n for _, _, n in counts)} samples",
              flush=True)
        for tag, got, ref in (("card vs CPU f32, own samples", g_card, g_own),
                              ("card vs CPU f32, the card's samples", g_card, g_shared),
                              ("card vs CPU f64, the card's samples", g_card, g_64),
                              ("CPU f32 vs CPU f64, both the card's samples", g_shared, g_64),
                              ("CPU f32 own vs CPU f32 the card's samples", g_own, g_shared)):
            ratio, name = worst(got, ref)
            print(f"[cause] {steps} steps, {tag}: worst {ratio:.4f} ({name}); {spread(got, ref)}", flush=True)
    if device == "cuda":
        print(torch.cuda.get_device_name(0))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "card"
    if mode == "cause-cpu":  # a rehearsal of `cause` on the CPU at 2 narrow layers: no flips, the code paths only
        cause("cpu", 2, dict(vocab_size=200, d_model=64, dim_feedforward=128, att_feat_size=32))
    else:
        {"card": card, "ulp": ulp, "cause": cause}[mode]()

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

Each line gives the norm-wise relative difference of every parameter's
gradient (median, 90th percentile) and, for ``card``, the five worst tensors
in ``chip_smoke.py``'s norm-wise units (<= 1 passes). Weights, masks and
inputs are random from fixed seeds.
"""

from __future__ import annotations

import copy
import sys

import torch

PAPER = dict(vocab_size=10000, d_model=512, dim_feedforward=2048, num_layers=6, num_heads=8, att_feat_size=2048,
             max_seq_length=17)
LOO = torch.tensor([0.4566, -0.2283, -0.2283, 0.4566, -0.2283, -0.2283])  # leave-one-out rewards of 2 x 3 samples


def build(device: str, layers: int):
    """A supermask ORT at paper width, mask logits N(0, 1), and a 2-image batch."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig, split_params

    g = torch.Generator(device=device).manual_seed(15)
    model = get_model("relation_transformer_prune")(**dict(PAPER, num_layers=layers), device=device, generator=g,
                                                    mask_cfg=MaskConfig("supermask", 5.0, keep_masks=True))
    with torch.no_grad():
        for m in split_params(model)[1].values():
            m.copy_(torch.randn(m.shape, generator=g, device=device))
    att = torch.randn(2, 36, 2048, generator=g, device=device)
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


if __name__ == "__main__":
    {"card": card, "ulp": ulp}[sys.argv[1] if len(sys.argv) > 1 else "card"]()

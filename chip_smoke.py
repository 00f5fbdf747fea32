#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sparse_caption_tpu_torch``) on one GPU.

Phases:
1. set-up: card name and power limit, versions, build of the four kernels
   (``kernels/csrc/*.cu``, nvcc for sm_90a, one process per source);
2. kernel checks: each kernel against its plain PyTorch version at the
   shapes of the paper-width beam-5 path (B = 2048 images, 36 regions, 8
   heads of 64, vocab 10000, 17 steps), in f32 and bf16, and the times of
   kernel, plain version and one PyTorch library call;
3. main path: a paper-width ``relation_transformer_prune`` (random weights
   and supermask logits from a seed, masks folded), ``encode`` + beam-5
   ``generate`` in bf16 at batch 50 and 2048 with the kernels' launch counts
   asserted, and the same weights in f32 at batch 8 on the card against the
   CPU's plain versions (identical tokens, log-probs within 1e-4).

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the card's name and power limit, and before that one JSON line with every
kernel's numbers. Exits non-zero, without the ok line, when CUDA is absent or
any phase fails.

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

PAPER = dict(vocab_size=10000, d_model=512, dim_feedforward=2048, num_layers=6, num_heads=8, att_feat_size=2048,
             max_seq_length=17)
REGIONS, BEAM, MAX_LEN, HEADS, DK = 36, 5, 17, 8, 64
BIG_BATCH, EVAL_BATCH, CHECK_BATCH = 2048, 50, 8
SEED = 0  # weights, inputs and supermask logits all come from it
# kernel vs plain version, element by element. f32: |a - b| <= 1e-5 + 1e-5 |b|
# (the two differ by summation order only). bf16: |a - b| <= u (2 |b| + 8 s),
# u = 2^-8 the unit roundoff of bf16 and s the scale of the values attended
# over (rms of V; 0 for beam top-K): 2 u |b| is one bf16 ulp of |b| for the
# two outputs' own final roundings; 8 u s covers the plain version rounding
# scores (|score| up to ~6) and probabilities to bf16 where the kernel keeps
# f32, which moves each probability by a few u and the output by that times
# a value row. Each check prints its worst err/allowed, and a planted fault
# (one part of the function left out) must fail the same bound.
F32_TOL = 1e-5
BF16_U = 2.0 ** -8
BF16_SCALE_UNITS = 8
WHOLE_PATH_LP_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor core / f32 CUDA cores
ESIZE = {torch.float32: 4, torch.bfloat16: 2}
REPLACES = {
    "box_attention": "sparse_caption_tpu/models/layers.py:406",
    "ancestry_self_attention": "sparse_caption_tpu/models/layers.py:280",
    "grouped_cross_attention": "sparse_caption_tpu/models/layers.py:236",
    "beam_topk": "sparse_caption_tpu/models/layers.py:458",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def allowed(b, dtype, scale: float = 0.0):
    """Per-element error allowed against the plain version's output `b`
    (`scale`: rms of the values attended over, see BF16_SCALE_UNITS)."""
    b = b.float()
    if dtype == torch.float32:
        return F32_TOL + F32_TOL * b.abs()
    return BF16_U * (2 * b.abs() + BF16_SCALE_UNITS * scale)


def close(a, b, dtype, scale: float = 0.0):
    """(max |a - b|, every element within its allowed error, worst |a - b| / allowed)."""
    ratio = (a.float() - b.float()).abs() / allowed(b, dtype, scale)
    return (a.float() - b.float()).abs().max().item(), bool((ratio <= 1).all()), ratio.max().item()


def rms(x) -> float:
    return x.float().pow(2).mean().sqrt().item()


def fault_caught(name, fault, ref, dtype, scale) -> bool:
    """A planted fault (`fault`: the plain version with one part of the
    function left out) must fail the tolerance the kernel is held to."""
    ratio = (fault.float() - ref.float()).abs() / allowed(ref, dtype, scale)
    frac = (ratio > 1).float().mean().item()
    log(f"[fault] {name} {str(dtype).split('.')[-1]}: {frac:.3f} of elements outside the tolerance "
        f"(worst err/allowed {ratio.max().item():.1f}) {'caught' if frac > 0 else 'MISSED'}")
    return frac > 0


def flops(*pairs) -> dict:
    """{dtype: operations} summed over (dtype, operations) pairs."""
    out: dict = {}
    for dtype, n in pairs:
        out[dtype] = out.get(dtype, 0) + n
    return out


def bound_ms(nbytes: float, flops_by_dtype: dict) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / PEAK_FLOPS[d] for d, f in flops_by_dtype.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_boxes(gen, b, r, device):
    xy = torch.rand(b, r, 2, generator=gen, device=device) * 400
    wh = torch.rand(b, r, 2, generator=gen, device=device) * 190 + 10
    return torch.cat([xy, xy + wh], dim=-1)


def random_region_mask(gen, b, r, device):
    """(B, R) bool: each image keeps its first 10..R regions."""
    n_valid = torch.randint(10, r + 1, (b, 1), generator=gen, device=device)
    return torch.arange(r, device=device)[None, :] < n_valid


# ------------------------------------------------------------ kernel checks
def check_kernels(gen, dtype, results: dict) -> bool:
    """Each kernel vs its plain version at the main path's shapes; timings."""
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import beam_topk as k4
    from sparse_caption_tpu_torch.kernels import box_attention as k1
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3
    from sparse_caption_tpu_torch.ops.attention import NEG_INF

    dev = torch.device("cuda")
    es = ESIZE[dtype]
    dname = str(dtype).split(".")[-1]
    b, n, r, h, dk, t_max, vocab = BIG_BATCH, BIG_BATCH * BEAM, REGIONS, HEADS, DK, MAX_LEN, PAPER["vocab_size"]
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev).to(dtype)  # noqa: E731
    ok = True

    def compare(name, out, ref, scale=0.0, fault=None):
        """Kernel output vs plain version; with `fault`, also show that the
        tolerance fails a plain version with one part left out."""
        nonlocal ok
        err, good, worst = close(out, ref, dtype, scale)
        log(f"[kernel] {name} {dname}: max_abs_err={err:.3e} worst err/allowed={worst:.3f} "
            f"median|ref|={ref.float().abs().median().item():.3e} value scale={scale:.3f} {'ok' if good else 'FAIL'}")
        ok &= good
        if fault is not None:
            ok &= fault_caught(name, fault, ref, dtype, scale)
        return err, good

    def record(name, err, ms, plain_ms, lib_ms, nbytes, ops):
        bnd, by = bound_ms(nbytes, ops)
        log(f"[kernel] {name} {dname}: ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
            f"bound_ms={bnd:.4f} ({by})")
        if dtype == torch.bfloat16:  # the main path's dtype goes into the JSON line
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                                 bound_by=by)

    # K1 box attention: (B, h, R, dk) q/k/v, boxes, wg (h, 64). wg has 4
    # entries of +-0.225 per head, so |wg . geo| <= 0.9 and w_g = relu(. + 1)
    # lies in [0.1, 1.9]: the log-bias spans [-2.3, 0.64] (std ~0.4, like the
    # scores') and stays away from relu's kink, where log(max(w_g, 1e-6))
    # turns a last-bit difference of the 64-term dot into an O(1) bias
    # difference that no tolerance can hold (the main path's random weights
    # reach the kink; the whole-path f32 check covers them)
    q, k, v = rnd(b, h, r, dk), rnd(b, h, r, dk), rnd(b, h, r, dk)
    boxes = random_boxes(gen, b, r, dev)
    picks = torch.rand(h, 64, generator=gen, device=dev).argsort(dim=1)[:, :4]
    signs = torch.randint(0, 2, (h, 4), generator=gen, device=dev).float() * 2 - 1
    wg_w = torch.zeros(h, 64, device=dev).scatter_(1, picks, signs * 0.225).to(dtype)
    wg_b = torch.ones(h, device=dev).to(dtype)
    mask = random_region_mask(gen, b, r, dev)
    args = (q, k, v, boxes, wg_w, wg_b, mask)
    from sparse_caption_tpu_torch.ops.attention import box_relational_embedding, scaled_dot_attention

    geo = box_relational_embedding(boxes)
    bias = torch.log(torch.clamp(torch.relu(F.linear(geo.to(dtype), wg_w, wg_b)), min=1e-6)).permute(0, 3, 1, 2)
    log(f"[kernel] box_attention {dname}: geometry log-bias in [{bias.min().item():.3f}, {bias.max().item():.3f}], "
        f"std {bias.float().std().item():.3f}")
    err, _ = compare("box_attention", k1.box_attention(*args), k1.box_attention_plain(*args), rms(v),
                     fault=scaled_dot_attention(q, k, v, mask=mask[:, None, None, :]))  # geometry bias dropped
    float_mask = bias.masked_fill(~mask[:, None, None, :], NEG_INF).to(dtype).contiguous()
    record("box_attention", err,
           time_ms(lambda: k1.box_attention(*args)), time_ms(lambda: k1.box_attention_plain(*args), iters=5),
           time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=float_mask)),
           4 * b * h * r * dk * es + b * r * 4 * 4 + b * r + h * 65 * es,
           flops((dtype, 4 * b * h * r * r * dk), (torch.float32, 2 * b * r * r * 64 * h)))

    # K2 ancestry self-attention at step 5 and at the last step (full cache)
    q = rnd(n, h, dk)
    ck, cv = rnd(n, h, t_max, dk), rnd(n, h, t_max, dk)
    anc = torch.randint(0, BEAM, (b, BEAM, t_max), generator=gen, device=dev, dtype=torch.int32)
    for step in (5, t_max - 1):
        anc_t = anc.clone()
        anc_t[:, :, step] = torch.arange(BEAM, device=dev, dtype=torch.int32)
        err, _ = compare(f"ancestry_self_attention t={step}", k2.ancestry_self_attention(q, ck, cv, anc_t, step),
                         k2.ancestry_self_attention_plain(q, ck, cv, anc_t, step), rms(cv),
                         fault=k2.ancestry_self_attention_plain(q, ck, cv, None, step))  # ancestry ignored
    step = t_max - 1
    rows = (anc_t.long() + torch.arange(b, device=dev)[:, None, None] * BEAM).reshape(n, t_max)
    slots = torch.arange(t_max, device=dev)
    kg = ck.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous()  # physically reordered cache
    vg = cv.transpose(1, 2)[rows, slots].transpose(1, 2).contiguous()
    # beams of one image share ancestors: the cache slots this data needs are
    # the distinct (ancestor row, slot) pairs, not N * T_max
    touched = torch.unique(rows * t_max + slots).numel()
    q4 = q[:, :, None]
    record("ancestry_self_attention", err,
           time_ms(lambda: k2.ancestry_self_attention(q, ck, cv, anc_t, step)),
           time_ms(lambda: k2.ancestry_self_attention_plain(q, ck, cv, anc_t, step), iters=5),
           time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg)),
           2 * touched * h * dk * es + 2 * n * h * dk * es + n * t_max * 4,
           flops((dtype, 4 * n * h * t_max * dk)))

    # K3 grouped cross-attention: beam rows share their image's memory K/V
    q = rnd(n, h, dk)
    mk, mv = rnd(b, h, r, dk), rnd(b, h, r, dk)
    mask = random_region_mask(gen, b, r, dev)
    no_mask = torch.ones_like(mask)
    err, _ = compare("grouped_cross_attention", k3.grouped_cross_attention(q, mk, mv, mask),
                     k3.grouped_cross_attention_plain(q, mk, mv, mask), rms(mv),
                     fault=k3.grouped_cross_attention_plain(q, mk, mv, no_mask))  # padding attended
    compare("grouped_cross_attention mem_v=None", k3.grouped_cross_attention(q, mk, None, mask),
            k3.grouped_cross_attention_plain(q, mk, None, mask), rms(mk))
    qg = q.reshape(b, BEAM, h, dk).transpose(1, 2)  # (B, h, K, dk): the beams as query rows
    cross_mask = torch.zeros(b, 1, 1, r, device=dev, dtype=dtype).masked_fill(~mask[:, None, None, :], NEG_INF)
    record("grouped_cross_attention", err,
           time_ms(lambda: k3.grouped_cross_attention(q, mk, mv, mask)),
           time_ms(lambda: k3.grouped_cross_attention_plain(q, mk, mv, mask), iters=5),
           time_ms(lambda: F.scaled_dot_product_attention(qg, mk, mv, attn_mask=cross_mask)),
           2 * b * h * r * dk * es + 2 * n * h * dk * es + b * r,
           flops((dtype, 4 * n * h * r * dk)))

    # K4 beam top-k with every constraint on
    logits = rnd(n, vocab)
    ban_token = torch.randint(0, vocab, (n,), generator=gen, device=dev, dtype=torch.int32)
    ban_eos = torch.rand(n, generator=gen, device=dev) < 0.3
    kw = dict(ban_token=ban_token, ban_eos=ban_eos, eos_id=3, unk_id=1)
    vals, idx, raw = k4.beam_topk(logits, BEAM, **kw)
    pvals, pidx, praw = k4.beam_topk_plain(logits, BEAM, **kw)
    _, c = k4.constrained_logprobs(logits, **kw)
    err_v, _ = compare("beam_topk values", vals, pvals)
    # an index may differ from the plain one only at a near-tie: then the plain
    # constrained value at the kernel's index must match the rank's value
    differ = idx != pidx
    at_kernel_idx = c.gather(1, idx.long())
    tie_ok = bool(((at_kernel_idx - pvals).abs() <= allowed(pvals, dtype))[differ].all())
    err_r, _ = compare("beam_topk raw log-probs", raw, torch.log_softmax(logits, dim=-1).float().gather(1, idx.long()))
    log(f"[kernel] beam_topk: indices differing {int(differ.sum())}/{differ.numel()} (near-ties ok={tie_ok})")
    ok &= tie_ok
    record("beam_topk", max(err_v, err_r),
           time_ms(lambda: k4.beam_topk(logits, BEAM, **kw)),
           time_ms(lambda: k4.beam_topk_plain(logits, BEAM, **kw), iters=5),
           time_ms(lambda: torch.topk(torch.log_softmax(logits, dim=-1), BEAM)),
           n * vocab * es + n * 5 + 3 * n * BEAM * 4,
           flops((torch.float32, 4 * n * vocab)))
    return ok


# ---------------------------------------------------------------- main path
def build_model(seed: int):
    """Paper-width relation_transformer_prune in f32 on the card, random
    weights and supermask logits from the seed, masks folded."""
    from sparse_caption_tpu_torch.models import get_model
    from sparse_caption_tpu_torch.ops.masked import MaskConfig, MaskedEmbedding, MaskedLinear

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = get_model("relation_transformer_prune")(**PAPER, mask_cfg=MaskConfig("supermask"), device="cuda",
                                                    generator=gen)
    kept = total = 0
    for m in model.modules():
        if isinstance(m, (MaskedLinear, MaskedEmbedding)):
            logits = torch.randn(m.weight.shape, generator=gen, device="cuda") * 2.0 + 1.0
            m.fold_mask_(logits)
            kept += int((logits > 0).sum())
            total += logits.numel()
    log(f"[model] supermask folded: {kept / total:.3f} of {total} masked weights kept")
    return model


def make_batch(gen, b, dtype, device="cuda"):
    att = torch.randn(b, REGIONS, PAPER["att_feat_size"], generator=gen, device=device).to(dtype)
    mask = random_region_mask(gen, b, REGIONS, device).float()
    boxes = random_boxes(gen, b, REGIONS, device)
    return att, mask, boxes


def caption(model, batch):
    from sparse_caption_tpu_torch.decoding import generate

    memory = model.encode(*batch)
    return generate(model, memory, {"beam_size": BEAM, "max_seq_length": MAX_LEN})


def run_main_path(model_bf16, gen, b, expected) -> dict:
    from sparse_caption_tpu_torch.kernels import launch_counts, reset_launch_counts

    batch = make_batch(gen, b, torch.bfloat16)
    seq, lp = caption(model_bf16, batch)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    seq, lp = caption(model_bf16, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == expected, f"launch counts {counts} != {expected}"
    assert seq.shape == (b, BEAM, MAX_LEN) and lp.shape == (b, BEAM, MAX_LEN)
    assert bool(torch.isfinite(lp).all()), "non-finite log-probs"
    assert int(seq.min()) >= 0 and int(seq.max()) < PAPER["vocab_size"]
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        caption(model_bf16, batch)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    enc_ms = time_ms(lambda: model_bf16.encode(*batch), iters=3, warmup=1)
    log(f"[main] bf16 batch {b}: {b / best:.1f} captions/s (best of 3: {best * 1e3:.1f} ms per encode+decode; "
        f"encode alone {enc_ms:.1f} ms); launches {counts}")
    return counts


def profile_decode(model_bf16, gen, b) -> None:
    """Device time by kernel over one encode + decode (torch.profiler), and
    the device's busy share of that same window's wall time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    batch = make_batch(gen, b, torch.bfloat16)
    caption(model_bf16, batch)
    torch.cuda.synchronize()
    # step 1 warms the profiler up (its start-up costs seconds of host time);
    # step 2 is the recorded window, timed on the host around the same calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        caption(model_bf16, batch)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        caption(model_bf16, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the step's own range ("ProfilerStep#2") spans the window on the device's
    # timeline too; it is not a kernel
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and dev_us(e) > 0 and not e.key.startswith("ProfilerStep")]
    total_ms = sum(dev_us(e) for e in events) / 1e3
    # one stream, so kernels do not overlap; the profiler's per-call host work
    # lengthens the window, so the share is a lower bound for an unprofiled run
    log(f"[profile] batch {b}: device kernels {total_ms:.1f} ms in {wall_ms:.1f} ms wall of the same window, "
        f"busy {total_ms / wall_ms:.1%}")
    for e in sorted(events, key=lambda e: -dev_us(e))[:15]:
        log(f"[profile]   {dev_us(e) / 1e3:9.2f} ms  x{e.count:<6d} {e.key[:90]}")


def whole_path_check(model_f32, gen) -> bool:
    """f32 on the card (kernels) vs the CPU (plain versions) on the same weights."""
    batch = make_batch(gen, CHECK_BATCH, torch.float32)
    seq_gpu, lp_gpu = caption(model_f32, batch)
    model_cpu = copy.deepcopy(model_f32).to("cpu")
    seq_cpu, lp_cpu = caption(model_cpu, tuple(x.cpu() for x in batch))
    same = bool(torch.equal(seq_gpu.cpu(), seq_cpu))
    err = (lp_gpu.cpu() - lp_cpu).abs().max().item()
    log(f"[whole-path] f32 batch {CHECK_BATCH}: tokens identical={same} seq log-prob max_abs_err={err:.3e} "
        f"(tol {WHOLE_PATH_LP_TOL})")
    if not same:
        rows = (seq_gpu.cpu() != seq_cpu).any(-1).nonzero().tolist()
        log(f"[whole-path] differing (image, beam) rows: {rows[:10]}")
    return same and err <= WHOLE_PATH_LP_TOL


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from sparse_caption_tpu_torch.kernels import KERNELS, _build, build_all

    card = card_line()
    log(f"[setup] card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    per_lib = build_all(verbose=True)
    log(f"[setup] kernels built in {time.perf_counter() - t0:.1f}s: {per_lib}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results: dict = {}
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        ok &= check_kernels(gen, dtype, results)
    if not ok:
        log("[kernel] a kernel disagrees with its plain version")
        return 1

    model = build_model(SEED)
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    layers = PAPER["num_layers"]
    expected = {"box_attention": layers, "ancestry_self_attention": layers * MAX_LEN,
                "grouped_cross_attention": layers * MAX_LEN, "beam_topk": MAX_LEN}
    run_main_path(model_bf16, gen, EVAL_BATCH, expected)
    counts = run_main_path(model_bf16, gen, BIG_BATCH, expected)
    log(f"[main] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_decode(model_bf16, gen, BIG_BATCH)
    del model_bf16
    if not whole_path_check(model, gen):
        return 1

    kernels = []
    for name in KERNELS:
        src = _build.CSRC / f"{name}.cu"
        kernels.append(dict(name=name, route="cuda", source=str(src.relative_to(_build.CSRC.parents[2])),
                            replaces=REPLACES[name], launches=counts[name], **results[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

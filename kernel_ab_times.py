"""Device times of K9's modes (random, greedy, Gumbel, top-k at k 3 and 20,
nucleus at p 0.9 / T 0.7, scheduled sampling), of K4 on its held rows, its
scalar rows (V = 771) and its diverse rows, of K13 in bf16, of K2's forward
and backward and K3 at head width 13 and K3's backward, and of K1, K1's
train variant and K7 on the trig geometry, in the tree of the working
directory, so that two commits can be timed on one card in one run (NVIDIA
H100; imports no JAX).

    python3 kernel_ab_times.py build <tag> [k9|decode|attention]          # build the libraries (ptxas report)
    python3 kernel_ab_times.py time <tag> [k9|decode|attention [regex]]   # one JSON line of device ms
    python3 kernel_ab_times.py losses <file of time lines>                # attention rows' losses (CPU)

With `k9` only K9's library is built and timed, with `decode` K9's, K4's
and K13's (with a regex, only the rows whose names match it: K9 random,
greedy, gumbel, top3, top20, top0.9, ss; K4 held, scalar V771, diverse;
K13 bf16 fwd+bwd at the Up-Down XE step's 21,760 rows and fwd alone at
10,240, bf16 -> f32 at ACORT's V = 771). With `attention` K2's and K3's
(and both backwards): every K2 forward instance of a path at every step of its cache on
a uniform random map (its bound, ``k2_bytes``, beside each time) and at the
last step on the collapsed map: "K2 dk64" (the ORT's serving step, bf16, 2,048 x 5 rows, T_max 17),
"K2 kv dk64" (ACORT-base, 26), "K2 dk32" and "K2 kv dk32" (ACORT-small,
26), "K2 dk13" (ORT-xsmall, 17) and "K2 identity dk64 f32" (the SCST
sampling decode, 960 rows, the identity map); K2's backward at the first,
middle and last step (``chip_smoke.k2_steps``; f32, 960 rows, 64 images x
15, the identity or a random map: "K2
bwd [anc ][kv ]dk<dk>" on the SCST gradient passes' caches, 17 or 25
slots); K3 at dk 13 at ORT-xsmall's serving step (bf16, 2,048 x 5) and its
SCST group (f32, 64 x 15), 36 regions; K3's backward (f32, 64 x 15, 36
regions, 8 heads: "K3 bwd [kv ]dk<dk>", the same at every step); each row
"<name> t=<t> [collapsed]" (K3's backward "<name>") with "<row> bound"
beside it. `losses` reads the lines of such runs and gives each row of
ATTENTION_PATHS its loss on its path by the rule of
``chip_smoke.steps_loss`` (a row timed once: the same time at every step),
from the mean of each tag's runs.
The helpers come from the chip_smoke.py beside this script, the kernels from
the working directory's tree. Run it from the root of
each tree (for the parent: `git archive` unpacked into an ignored
directory, e.g. build/parent, and `python3 ../../kernel_ab_times.py ...`
from there), in the order parent, change, change, parent. Times are
chip_smoke.turns_ms medians (5 held windows of 20 calls); K9 at 960 x
10,000 f32 and 10,240 x 10,000 bf16 (logits at scale 3), K4 at 10,240 x
10,000 bf16, k 5 (the serving step) and 2,048 images x 2 rows, 4
earlier-group tokens an image, lambda 0.5 (the third group of diverse beam
6 / 3), every constraint on; K1 at 2048 images, K1 train and K7 (autograd)
at 256, 8 heads, 36 regions, dk 64.
"""
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from sparse_caption_tpu_torch.kernels import _build  # noqa: E402

# the attention rows' paths: (launches a step, steps), for the loss rule (chip_smoke.steps_loss)
ATTENTION_PATHS = {
    "K2 dk64": (6, 17),  # ORT serving
    "K2 kv dk64": (6, 26),  # ACORT-base serving
    "K2 kv dk32": (6, 26),  # ACORT-small serving
    "K2 dk13": (6, 17),  # ORT-xsmall serving
    "K2 identity dk64 f32": (6, 17),  # the ORT's SCST sampling decode
    "K2 bwd dk64": (6, 17),  # supermask SCST's gradient pass
    "K2 bwd anc dk64": (6, 17),  # beam-sample SCST's
    "K2 bwd kv dk32": (6, 25),  # ACORT-small supermask SCST
    "K2 bwd anc kv dk32": (6, 25),  # ACORT-small beam-sample SCST
    "K2 bwd dk13": (6, 17),  # ORT-xsmall supermask SCST
    "K2 bwd anc dk13": (6, 17),  # ORT-xsmall beam-sample SCST
    "K2 bwd kv dk64": (6, 25),  # ACORT-base supermask SCST
    "K3 bwd dk64": (6, 17),  # the ORT's supermask SCST
    "K3 bwd kv dk64": (6, 25),  # ACORT-base supermask SCST
    "K3 bwd kv dk32": (6, 25),  # ACORT-small supermask SCST (and its beam-sample SCST, the same again)
    "K3 bwd dk13": (6, 17),  # ORT-xsmall supermask SCST (and its beam-sample SCST, the same again)
}


def losses(path: str) -> None:
    """The attention rows' losses (CPU): for each tag of the JSON lines in
    `path` (``time <tag> attention`` runs), each row's mean time and bound at
    the timed steps, and its loss on its path by ``chip_smoke.steps_loss``."""
    runs = [json.loads(line) for line in open(path) if line.startswith("{")]
    by_tag = {}
    for r in runs:
        by_tag.setdefault(r["tag"], []).append(r)
    report = {}
    for tag, rs in by_tag.items():
        rs = [r for r in rs if any(key.startswith("K2 ") or key.startswith("K3 ") for key in r)]  # attention runs
        for row, (per_step, steps) in ATTENTION_PATHS.items():
            timed = {}
            for key in rs[0] if rs else ():
                m = re.fullmatch(re.escape(row) + r" t=(\d+)", key)
                if m or key == row:
                    ms = sum(r[key] for r in rs) / len(rs)
                    for t in (int(m.group(1)),) if m else (0, steps - 1):
                        timed[t] = (ms, rs[0][f"{key} bound"])
            if timed:
                report[f"{tag} {row}"] = dict(
                    timed={t: (round(ms, 4), round(b, 4)) for t, (ms, b) in sorted(timed.items())},
                    loss=round(c.steps_loss(per_step, steps, timed), 2))
    print(json.dumps(report, indent=1), flush=True)


what, tag = sys.argv[1], sys.argv[2]
if what == "losses":
    losses(tag)
    sys.exit(0)
only = sys.argv[3] if len(sys.argv) > 3 else ""
pick = re.compile(sys.argv[4] if len(sys.argv) > 4 else "")
_build.SOURCES = {"k9": ("sample_step",), "decode": ("sample_step", "beam_topk", "vocab_log_softmax"),
                  "attention": ("ancestry_self_attention", "grouped_cross_attention", "ancestry_self_attention_bwd",
                                "ancestry_self_attention_bwd_anc", "grouped_cross_attention_bwd")}.get(
    only, ("sample_step", "beam_topk", "box_attention", "box_attention_bwd"))
if what == "build":
    print(json.dumps({"tag": tag, "compile_s": _build.build_all(verbose=True)}), flush=True)
    sys.exit(0)
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False


def attention_times(g) -> dict:
    """K2's forward instances and K3 at dk 13 (the module docstring's rows)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", Path(__file__).resolve().parent / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    from sparse_caption_tpu_torch.kernels import ancestry_self_attention as k2
    from sparse_caption_tpu_torch.kernels import grouped_cross_attention as k3

    out = {}
    h, images, beam = 8, 2048, 5
    for name, dk, t_max, kv, dtype, rows in (("K2 dk64", 64, 17, False, torch.bfloat16, None),
                                             ("K2 kv dk64", 64, 26, True, torch.bfloat16, None),
                                             ("K2 dk32", 32, 26, False, torch.bfloat16, None),
                                             ("K2 kv dk32", 32, 26, True, torch.bfloat16, None),
                                             ("K2 dk13", 13, 17, False, torch.bfloat16, None),
                                             ("K2 identity dk64 f32", 64, 17, False, torch.float32, 960)):
        if not pick.search(name):
            continue
        n = rows or images * beam
        q, ck, cv = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                     for shape in ((n, h, dk), (n, h, t_max, dk), (n, h, t_max, dk)))
        cv = None if kv else cv
        anc = None if rows else torch.randint(0, beam, (images, beam, t_max), generator=g, device=dev,
                                              dtype=torch.int32)
        root = None if rows else torch.randint(0, beam, (images,), generator=g, device=dev, dtype=torch.int32)
        fns, bounds = {}, {}
        for t in range(t_max):  # every step: the time is not linear in t where the kernel changes path
            for kind in ("uniform",) + (("collapsed",) if anc is not None and t == t_max - 1 else ()):
                anc_t = None if anc is None else here.k2_map(anc, kind, t, root)
                row = f"{name} t={t}" + (" collapsed" if kind == "collapsed" else "")
                fns[row] = lambda a=anc_t, t=t: k2.ancestry_self_attention(q, ck, cv, a, t)
                bounds[row] = here.bound_ms(here.k2_bytes(n, t, dtype, anc_t, h, dk, kv), {})[0]
        for row, ms in zip(fns, c.turns_ms(*fns.values())):
            out[row], out[f"{row} bound"] = ms, bounds[row]
        del q, ck, cv
    # K2's backward (f32, 960 rows: 64 images x 15) on the SCST gradient passes' caches, the same steps
    for name, dk, t_max, kv, mapped in (("K2 bwd dk64", 64, 17, False, False), ("K2 bwd anc dk64", 64, 17, False, True),
                                        ("K2 bwd kv dk32", 32, 25, True, False),
                                        ("K2 bwd anc kv dk32", 32, 25, True, True),
                                        ("K2 bwd dk13", 13, 17, False, False), ("K2 bwd anc dk13", 13, 17, False, True),
                                        ("K2 bwd kv dk64", 64, 25, True, False)):
        if not pick.search(name):
            continue
        b, kb = 64, 15
        n = b * kb
        q, dout = (torch.randn(n, h, dk, generator=g, device=dev) for _ in range(2))
        caches = [torch.randn(n, h, t_max, dk, generator=g, device=dev) for _ in range(1 if kv else 2)]
        grads = [torch.zeros_like(c) for c in caches]
        cv, dcv = (None, None) if kv else (caches[1], grads[1])
        fns, bounds = {}, {}
        for t in here.k2_steps(t_max):
            anc = here.anc_map("random", b, kb, t_max, t, g, dev) if mapped else None
            row = f"{name} t={t}"
            fns[row] = lambda a=anc, t=t: k2.ancestry_self_attention_backward(q, caches[0], cv, dout, grads[0], dcv, t,
                                                                              a)
            nbytes = here.k2_bwd_anc_bytes(anc, t, h, dk, kv) if mapped else here.k2_bwd_bytes(n, t, h, dk, kv)
            bounds[row] = here.bound_ms(nbytes, {})[0]
        for row, ms in zip(fns, c.turns_ms(*fns.values())):
            out[row], out[f"{row} bound"] = ms, bounds[row]
        del q, dout, caches, grads
    for name, b, rep, dtype in (("K3 dk13", images, beam, torch.bfloat16), ("K3 dk13 f32", 64, 15, torch.float32)):
        if not pick.search(name):
            continue
        q, mk, mv = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                     for shape in ((b * rep, h, 13), (b, h, 36, 13), (b, h, 36, 13)))
        valid = c.random_region_mask(g, b, 36, dev)
        (out[name],) = c.turns_ms(lambda: k3.grouped_cross_attention(q, mk, mv, valid))
        out[f"{name} bound"] = here.bound_ms(here.k3_bytes(b, rep, dtype, dk=13), {})[0]
    # K3's backward (f32, 64 images x 15 rows, 36 regions, image 0 with none valid): the path instances, then the
    # other two
    b, rep = 64, 15
    for name, dk, kv in (("K3 bwd dk64", 64, False), ("K3 bwd kv dk64", 64, True), ("K3 bwd kv dk32", 32, True),
                         ("K3 bwd dk13", 13, False), ("K3 bwd dk32", 32, False), ("K3 bwd kv dk13", 13, True)):
        if not pick.search(name):
            continue
        q, dout = (torch.randn(b * rep, h, dk, generator=g, device=dev) for _ in range(2))
        mk, mv = (torch.randn(b, h, 36, dk, generator=g, device=dev) for _ in range(2))
        mv = None if kv else mv
        valid = c.random_region_mask(g, b, 36, dev)
        valid[0] = False
        (out[name],) = c.turns_ms(lambda: k3.grouped_cross_attention_backward(q, mk, mv, valid, dout))
        out[f"{name} bound"] = here.bound_ms(here.k3_bwd_bytes(b, rep, 36, h, dk, kv), {})[0]
    return out


from sparse_caption_tpu_torch.kernels import beam_topk as k4  # noqa: E402
from sparse_caption_tpu_torch.kernels import box_attention as k1  # noqa: E402
from sparse_caption_tpu_torch.kernels import box_attention_bwd as k7  # noqa: E402
from sparse_caption_tpu_torch.kernels import sample_step as k9  # noqa: E402

dev = torch.device("cuda")
g = torch.Generator(device="cuda").manual_seed(7)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
res = {"tag": tag, "card": card}
if only == "attention":
    res.update(attention_times(g))
    print(json.dumps(res), flush=True)
    sys.exit(0)
for dtype, n in ((torch.float32, 960), (torch.bfloat16, 10240)):
    dn = str(dtype).split(".")[-1]
    logits = (torch.randn(n, 10000, generator=g, device=dev) * 3.0).to(dtype)
    prev = torch.randint(4, 10000, (n,), generator=g, device=dev, dtype=torch.int32)
    unf = torch.rand(n, generator=g, device=dev) < 0.8
    seq, lp = torch.zeros(n, 17, dtype=torch.int32, device=dev), torch.zeros(n, 17, device=dev)
    step = lambda **kw: lambda: k9.sample_step(logits, prev, unf, seq, lp, 5, key=12345, site=3, **kw)  # noqa: E731
    variants = {"random": step(), "greedy": step(greedy=True), "gumbel": step(sample_method="gumbel"),
                "top3": step(sample_method="top3"), "top20": step(sample_method="top20"),
                "top0.9 T0.7": step(sample_method="top0.9", temperature=0.7),
                "ss": lambda: k9.scheduled_sample(logits, prev, 0.25, k9.SSDraw(12345, 3))}
    variants = {name: fn for name, fn in variants.items() if pick.search(name)}
    for name, ms in zip(variants, c.turns_ms(*variants.values())):
        res[f"K9 {name} {dn} {n}"] = ms
if only != "k9":
    k4_rows = {}
    logits = torch.randn(10240, 10000, generator=g, device=dev).to(torch.bfloat16)
    kw = c.k4_constraints(g, 10240, 10000)
    k4_rows["K4 held bf16 10240 k5"] = lambda: k4.beam_topk(logits, 5, **kw)
    images, width = 2048, 2
    dlogits = torch.randn(images * width, 10000, generator=g, device=dev).to(torch.bfloat16)
    toks = torch.randint(4, 10000, (images, 4), generator=g, device=dev, dtype=torch.int32)
    toks[:, 1] = toks[:, 0]
    dkw = dict(c.k4_constraints(g, images * width, 10000), div_tokens=toks, div_lambda=0.5)
    k4_rows["K4 diverse bf16 4096 k2 P4"] = lambda: k4.beam_topk(dlogits, width, **dkw)
    slogits = torch.randn(10240, 771, generator=g, device=dev).to(torch.bfloat16)
    skw = c.k4_constraints(g, 10240, 771, eos_id=770, unk_id=1)
    k4_rows["K4 scalar bf16 10240 V771 k5"] = lambda: k4.beam_topk(slogits, 5, **skw)
    k4_rows = {name: fn for name, fn in k4_rows.items() if pick.search(name)}
    for name, ms in zip(k4_rows, c.turns_ms(*k4_rows.values())):
        res[name] = ms
    del logits, dlogits, slogits
    # K13: bf16 -> bf16 (the Up-Down XE step's rows, forward + backward; the eval forward alone), bf16 -> f32 at V = 771
    from sparse_caption_tpu_torch.kernels import vocab_log_softmax as k13

    k13_rows = {}
    for name, rows, vocab, tout, backward in (("K13 bf16 fwd+bwd 21760x10000", 21760, 10000, torch.bfloat16, True),
                                              ("K13 bf16 fwd 10240x10000", 10240, 10000, torch.bfloat16, False),
                                              ("K13 bf16->f32 fwd+bwd 33280x771", 33280, 771, torch.float32, True)):
        x = (torch.randn(rows, vocab, generator=g, device=dev) * 3).to(torch.bfloat16)
        if backward:
            xl = x.clone().requires_grad_()
            dy = torch.randn(rows, vocab, generator=g, device=dev).to(tout)
            k13_rows[name] = lambda xl=xl, dy=dy, tout=tout: c.fwd_bwd(lambda v: k13.vocab_log_softmax(v, tout), (xl,),
                                                                       (dy,))
        else:
            k13_rows[name] = lambda x=x: k13.vocab_log_softmax(x)
    k13_rows = {name: fn for name, fn in k13_rows.items() if pick.search(name)}
    for name, ms in zip(k13_rows, c.turns_ms(*k13_rows.values())):
        res[name] = ms
    del k13_rows
if only:
    print(json.dumps(res), flush=True)
    sys.exit(0)
h, rr, dk = 8, 36, 64
for dtype in (torch.bfloat16, torch.float32):
    dn = str(dtype).split(".")[-1]
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    for b in (2048,):
        q, k, v = rnd(b, h, rr, dk), rnd(b, h, rr, dk), rnd(b, h, rr, dk)
        boxes = c.random_boxes(g, b, rr, dev)
        picks = torch.rand(h, 64, generator=g, device=dev).argsort(dim=1)[:, :4]
        signs = torch.randint(0, 2, (h, 4), generator=g, device=dev).float() * 2 - 1
        wg_w = torch.zeros(h, 64, device=dev).scatter_(1, picks, signs * 0.225).to(dtype)
        wg_b = torch.ones(h, device=dev).to(dtype)
        mask = c.random_region_mask(g, b, rr, dev)
        (res[f"K1 trig {dn} {b}"],) = c.turns_ms(lambda: k1.box_attention(q, k, v, boxes, wg_w, wg_b, mask))
    b = 256
    q, k, v, dout = rnd(b, h, rr, dk), rnd(b, h, rr, dk), rnd(b, h, rr, dk), rnd(b, h, rr, dk)
    boxes = c.random_boxes(g, b, rr, dev)
    picks = torch.rand(h, 64, generator=g, device=dev).argsort(dim=1)[:, :4]
    signs = torch.randint(0, 2, (h, 4), generator=g, device=dev).float() * 2 - 1
    wg_w = torch.zeros(h, 64, device=dev).scatter_(1, picks, signs * 0.225).to(dtype)
    wg_b = torch.ones(h, device=dev).to(dtype)
    mask = c.random_region_mask(g, b, rr, dev)
    keep = torch.rand(b, h, rr, rr, generator=g, device=dev) < 0.9
    ins = [x.detach().clone().requires_grad_() for x in (q, k, v, wg_w, wg_b)]
    out = k7.box_attention_train(ins[0], ins[1], ins[2], boxes, ins[3], ins[4], mask, keep, 0.9)
    with torch.no_grad():
        (res[f"K1 train trig {dn} {b}"],) = c.turns_ms(
            lambda: k7.box_attention_train(q, k, v, boxes, wg_w, wg_b, mask, keep, 0.9))
    (res[f"K7 trig {dn} {b}"],) = c.turns_ms(lambda: torch.autograd.grad(out, ins, dout, retain_graph=True))
print(json.dumps(res), flush=True)

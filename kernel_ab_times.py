"""Device times of K9's modes (random, greedy, Gumbel, top-k at k 3 and 20,
nucleus at p 0.9 / T 0.7, scheduled sampling), of K4 on its held rows and
its diverse rows, and of K1, K1's train variant and K7 on the trig
geometry, in the tree of the working directory, so that two commits can be
timed on one card in one run (NVIDIA H100; imports no JAX).

    python3 kernel_ab_times.py build <tag> [k9|decode]          # build the libraries (ptxas report)
    python3 kernel_ab_times.py time <tag> [k9|decode [regex]]   # one JSON line of device ms

With `k9` only K9's library is built and timed, with `decode` K9's and
K4's (with a regex, only the rows whose names match it: K9 random, greedy,
gumbel, top3, top20, top0.9, ss; K4 held, diverse). Run it from the root of
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
import json
import re
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from sparse_caption_tpu_torch.kernels import _build  # noqa: E402

what, tag = sys.argv[1], sys.argv[2]
only = sys.argv[3] if len(sys.argv) > 3 else ""
pick = re.compile(sys.argv[4] if len(sys.argv) > 4 else "")
_build.SOURCES = {"k9": ("sample_step",), "decode": ("sample_step", "beam_topk")}.get(
    only, ("sample_step", "beam_topk", "box_attention", "box_attention_bwd"))
if what == "build":
    _build.build_all(verbose=True)
    sys.exit(0)
_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
from sparse_caption_tpu_torch.kernels import beam_topk as k4  # noqa: E402
from sparse_caption_tpu_torch.kernels import box_attention as k1  # noqa: E402
from sparse_caption_tpu_torch.kernels import box_attention_bwd as k7  # noqa: E402
from sparse_caption_tpu_torch.kernels import sample_step as k9  # noqa: E402

dev = torch.device("cuda")
g = torch.Generator(device="cuda").manual_seed(7)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
                      text=True).stdout.strip()
res = {"tag": tag, "card": card}
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
    k4_rows = {name: fn for name, fn in k4_rows.items() if pick.search(name)}
    for name, ms in zip(k4_rows, c.turns_ms(*k4_rows.values())):
        res[name] = ms
    del logits, dlogits
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

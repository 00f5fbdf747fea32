"""Device times of variants of K2's forward (``csrc/ancestry_self_attention.cu``)
that change or leave out one part, beside the kernel as it is and, where
``build/parent`` holds the parent commit's tree (``git archive``), the parent's
kernel, on one card in one run (NVIDIA H100; imports no JAX). The variants'
outputs are wrong where a part is left out: they are for timing only.

    python3 k2_variants.py        # from the repo root, on the machine with the card

Variants: "walk" (every step walks its slots one at a time: the design the
staged path replaced, one slot a lane), "staged" (every step staged),
"nocopy" (the staged path's cp.async copies left out), "nosoftmax" (its
softmax's max and sum left out), "nopv" (its p v left out), "ls1" (its
scores a lane a slot even where the row is short). Times are
chip_smoke.turns_ms medians (5 held windows of 20 calls) at B = 2,048 images
x beam 5, 8 heads, bf16, a uniform random map: dk 64 and 13 at T_max 17, dk
32 at 26 (unshared), at several steps; one JSON object, then the card's name
and power limit.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from sparse_caption_tpu_torch.kernels import _build  # noqa: E402
from sparse_caption_tpu_torch.ops.attention import score_divisor  # noqa: E402

CSRC = "sparse_caption_tpu_torch/kernels/csrc"
PARENT = "build/parent/" + CSRC
OUT = "build/variants/k2"
# name -> (old, new) edits of the source
VARIANTS = {
    "full": [],
    "walk": [("  if (t + 1 > kK2ChunkSlots) return true;\n  if (es != 2) return false;",
              "  if (t + 1 > kK2ChunkSlots) return true;\n  if (es != 0) return false;")],
    "staged": [("  if (es != 2) return false;", "  return true;")],
    "nocopy": [("    for (int e = lane; e < (c1 - c0) * NC; e += 32) {", "    for (int e = lane; e < 0; e += 32) {"),
               ("  if (es != 2) return false;", "  return true;")],
    "nosoftmax": [("  m = warp_max(m);", "  m = 0.f;"), ("  sum = warp_sum(sum);", "  sum = 1.f;"),
                  ("  if (es != 2) return false;", "  return true;")],
    "nopv": [("    for (int s = c0; s < c1; ++s) {", "    for (int s = c0; s < c0; ++s) {"),
             ("  if (es != 2) return false;", "  return true;")],
    "ls1": [("    if (n_slots > 16) {", "    if (true) {"), ("  if (es != 2) return false;", "  return true;")],
}


def build() -> dict:
    """Each variant's library (one nvcc each, in parallel), and the parent's where its tree is there."""
    base = open(f"{CSRC}/ancestry_self_attention.cu").read()
    jobs = {}
    sources = dict(VARIANTS)
    if os.path.exists(PARENT):
        sources["parent"] = None
    for name, edits in sources.items():
        d = f"{OUT}/{name}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(PARENT if edits is None else CSRC, d)
        if edits is not None:
            src = base
            for old, new in edits:
                if old not in src:
                    raise RuntimeError(f"variant {name}: the edit no longer applies: {old!r}")
                src = src.replace(old, new)
            open(f"{d}/ancestry_self_attention.cu", "w").write(src)
        nvcc = [_build._nvcc(), *(f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v"))]
        jobs[name] = subprocess.Popen([*nvcc, "-o", f"{d}.so", f"{d}/ancestry_self_attention.cu"])
    fns = {}
    for name, proc in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name} did not build")
        fn = ctypes.CDLL(os.path.abspath(f"{OUT}/{name}.so")).sct_ancestry_self_attention
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                                           ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    fns = build()
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    res = {}
    images, beam, h = 2048, 5, 8
    for dk, t_max in ((64, 17), (13, 17), (32, 26)):
        n, dtype = images * beam, torch.bfloat16
        q, ck, cv = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                     for shape in ((n, h, dk), (n, h, t_max, dk), (n, h, t_max, dk)))
        anc0 = torch.randint(0, beam, (images, beam, t_max), generator=g, device=dev, dtype=torch.int32)
        out = torch.empty_like(q)
        for t in sorted({0, 3, 8, 12, t_max // 2, t_max - 1}):
            anc = c.k2_map(anc0, "uniform", t)
            stream = torch.cuda.current_stream().cuda_stream
            calls = {name: (lambda fn=fn, a=anc, t=t: fn(1, dk, q.data_ptr(), ck.data_ptr(), cv.data_ptr(),
                                                       a.data_ptr(), out.data_ptr(), n, h, t_max, beam, t,
                                                       score_divisor(dk, dtype), stream))
                     for name, fn in fns.items()}
            for name, fn in calls.items():
                if fn() != 0:
                    raise RuntimeError(f"variant {name} failed to launch at dk {dk}, t {t}")
            for name, ms in zip(calls, c.turns_ms(*calls.values())):
                res[f"dk{dk} t={t} {name}"] = round(ms, 4)
    print(json.dumps(res), flush=True)
    print(c.card_line(), flush=True)


if __name__ == "__main__":
    main()

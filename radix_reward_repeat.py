"""K10's radix check (chip_smoke.py check_radix_reward) run many times on
its seeded inputs, to tell which side of the check moves between runs: the
radix mode and the word mode on the card, and the plain version on the CPU
(NVIDIA H100; imports no JAX).

    python3 radix_reward_repeat.py [runs] [processes]

In this process the inputs are built once and each side is run `runs`
times (default 50; the CPU side a fifth as often); each of `processes`
fresh processes (default 3) builds the inputs anew and runs each side once.
Every run's result is held bit for bit against this process's first; the
last line is one JSON object: the distinct results of each side, the
largest error against the plain version over all runs with its bound
(REWARD_RTOL |plain| + REWARD_ATOL), and the inputs' digests.
"""
import hashlib
import json
import subprocess
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def digest(*xs) -> str:
    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def inputs_digest(inp: dict) -> str:
    pack = [inp["pack"][k] for k in sorted(inp["pack"])]
    return digest(inp["ids"], inp["img"], *inp["tensors"].values(), *pack)


def card_sides(inp: dict) -> tuple:
    """(radix mode, word mode on the plain regroup's words) on the card."""
    from sparse_caption_tpu_torch.kernels import cider_reward as k10

    words = k10.radix_to_word(inp["ids"], inp["spec"])
    return (k10.cider_reward(inp["ids"], inp["img"], inp["tensors"], inp["pack"], radix=inp["spec"], **inp["kw"]),
            k10.cider_reward(words, inp["img"], inp["tensors"], inp["pack"], **inp["kw"]))


def once() -> dict:
    inp = c.radix_reward_inputs()
    got, word_mode, ref = c.radix_reward_sides(inp)
    return {"inputs": inputs_digest(inp), "radix": digest(got), "word": digest(word_mode), "plain": digest(ref)}


if __name__ == "__main__":
    from sparse_caption_tpu_torch.kernels import _build

    _build.SOURCES = ("cider_reward",)
    _build.build_all()
    if sys.argv[1:] == ["once"]:
        print(json.dumps(once()), flush=True)
        sys.exit(0)
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    procs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    inp = c.radix_reward_inputs()
    first = dict(zip(("radix", "word", "plain"), c.radix_reward_sides(inp)))
    bound = c.REWARD_RTOL * first["plain"].abs() + c.REWARD_ATOL
    seen = {side: {digest(x)} for side, x in first.items()}
    moved = {side: 0 for side in first}
    worst_err, worst_ratio = 0.0, 0.0
    for r in range(runs):
        now = dict(zip(("radix", "word"), card_sides(inp)))
        if r % 5 == 0:
            now["plain"] = c.radix_reward_sides(inp)[2]
        for side, x in now.items():
            seen[side].add(digest(x))
            moved[side] += int(not torch.equal(x, first[side]))
        for side in ("radix", "word"):
            err = (now[side] - now.get("plain", first["plain"])).abs()
            worst_err, worst_ratio = max(worst_err, err.max().item()), max(worst_ratio, (err / bound).max().item())
    fresh = []
    for _ in range(procs):
        out = subprocess.run([sys.executable, __file__, "once"], capture_output=True, text=True, check=True)
        fresh.append(json.loads(out.stdout.strip().splitlines()[-1]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "runs": runs, "plain_runs": (runs + 4) // 5,
                      "distinct": {k: len(v) for k, v in seen.items()}, "runs_differing_from_first": moved,
                      "max_abs_err": worst_err, "worst_err_over_bound": worst_ratio, "this_process": once(),
                      "fresh_processes": fresh}), flush=True)

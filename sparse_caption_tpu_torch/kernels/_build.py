"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` into ``build/torch_kernels/`` at the repo
root (listed in ``.gitignore``). All libraries build in parallel, one
``nvcc`` each, the first time any kernel launches (or when
``build_all()`` is called). A library's file name carries a hash of its
source, the headers it includes and the flags, so an edited source or
header rebuilds the libraries that include it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("box_attention", "ancestry_self_attention", "grouped_cross_attention", "beam_topk", "supermask",
           "add_ref_layernorm", "box_attention_bwd", "keyed_dropout", "sample_step", "cider_reward", "lstm_cell",
           "additive_attention", "vocab_log_softmax", "decoder_attention", "decoder_attention_bwd",
           "magnitude_threshold", "ancestry_self_attention_bwd", "grouped_cross_attention_bwd",
           "ancestry_self_attention_bwd_anc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return str(path)


def _local_sources(name: str) -> List[Path]:
    """``csrc/<name>`` and the ``csrc`` headers it includes, directly or through others."""
    seen, todo = [], [CSRC / name]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for line in path.read_text().splitlines():
            if line.startswith('#include "'):
                todo.append(CSRC / line.split('"')[1])
    return sorted(seen)


def _library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _local_sources(f"{name}.cu"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Compile every kernel library that is not built yet (in parallel) and load all.

    Returns each library's own compile seconds, from its ``nvcc``'s start to
    its exit (the processes are polled; "cached" ones count 0). With
    ``verbose`` the compiler's resource report (``-Xptxas -v``) is printed."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs: Dict[str, tuple] = {}
        seconds: Dict[str, float] = {}
        for name in SOURCES:
            if name in _libs:
                continue
            out = _library_path(name)
            if out.exists():
                seconds[name] = 0.0
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            log = out.with_suffix(f".{os.getpid()}.log")
            with open(log, "w") as sink:  # a file, not a pipe: a full pipe would stall a compiler
                proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                        stdout=sink, stderr=subprocess.STDOUT)
            jobs[name] = (out, tmp, log, proc, time.perf_counter())
        running = dict(jobs)
        while running:
            for name, (_, _, _, proc, start) in list(running.items()):
                if proc.poll() is not None:
                    seconds[name] = time.perf_counter() - start
                    del running[name]
            if running:
                time.sleep(0.05)
        failures = []
        for name, (out, tmp, log, proc, _) in jobs.items():
            text = log.read_text()
            log.unlink()
            if proc.returncode != 0:
                failures.append(f"--- {name} ---\n{text}")
                continue
            os.replace(tmp, out)
            if verbose:
                print(f"[build] {name}: {seconds[name]:.1f}s\n{text.strip()}", flush=True)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        for name in SOURCES:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_library_path(name)))
        return {name: seconds[name] for name in SOURCES if name in seconds}


def library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build_all()
    return _libs[name]


class CudaKernel:
    """One C entry point of a kernel library and its launch count.

    ``launches`` grows by one per successful launch on the GPU; the plain
    PyTorch versions that CPU tensors take never touch it."""

    def __init__(self, library_name: str, symbol: str, argtypes):
        self.library_name = library_name
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.library_name), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            lib = library(self.library_name)
            lib.sct_error_string.restype = ctypes.c_char_p
            lib.sct_error_string.argtypes = [ctypes.c_int]
            raise RuntimeError(f"{self.symbol} failed: CUDA error {err} ({lib.sct_error_string(err).decode()})")
        self.launches += 1


BLOCK_SMEM_LIMIT = 232448  # dynamic shared memory a block may use on the H100 (csrc/common.cuh)

P = ctypes.c_void_p
I = ctypes.c_int  # noqa: E741
U32 = ctypes.c_uint32
I64 = ctypes.c_longlong
F32 = ctypes.c_float


def dtype_code(t) -> int:
    """0 for float32, 1 for bfloat16 (the kernels' template switch)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if t.dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return codes[t.dtype]


def stream_handle(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def aligned16(t):
    """t itself if its data is 16-byte aligned (what the kernels' 16-byte copies
    need), else a fresh copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()

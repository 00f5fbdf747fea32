"""PyTorch/CUDA port of ``sparse_caption_tpu``.

The JAX package stays the reference; this package imports nothing of it (nor
of JAX) and keeps its own copies of the host-side helpers it needs. Entry
points run on the GPU unless the caller passes ``device="cpu"``, where every
hand-written kernel is replaced by its plain PyTorch version.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain PyTorch versions")
    return dev

"""Hand-written Hopper kernels of the serving path, each beside its plain PyTorch version.

==========================  ======================================  ==========================
wrapper                     CUDA source                             replaces (JAX package)
==========================  ======================================  ==========================
box_attention (K1)          csrc/box_attention.cu                   models/layers.py:338-439
ancestry_self_attention(K2) csrc/ancestry_self_attention.cu         models/layers.py:280-334
grouped_cross_attention(K3) csrc/grouped_cross_attention.cu         models/layers.py:236-264
beam_topk (K4)              csrc/beam_topk.cu                       layers.py:458-472, beam.py
==========================  ======================================  ==========================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built at first use, see ``_build``) or raises.
"""

from sparse_caption_tpu_torch.kernels import ancestry_self_attention as _k2
from sparse_caption_tpu_torch.kernels import beam_topk as _k4
from sparse_caption_tpu_torch.kernels import box_attention as _k1
from sparse_caption_tpu_torch.kernels import grouped_cross_attention as _k3
from sparse_caption_tpu_torch.kernels._build import build_all  # noqa: F401

# name -> CudaKernel (launch counts live on these objects)
KERNELS = {
    "box_attention": _k1.KERNEL,
    "ancestry_self_attention": _k2.KERNEL,
    "grouped_cross_attention": _k3.KERNEL,
    "beam_topk": _k4.KERNEL,
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}

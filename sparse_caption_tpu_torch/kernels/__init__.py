"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

================================  ===================================  =============================================
wrapper                           CUDA source                          replaces (JAX package)
================================  ===================================  =============================================
box_attention (K1)                csrc/box_attention.cu                models/layers.py:338-439
ancestry_self_attention (K2)      csrc/ancestry_self_attention.cu      models/layers.py:280-334
grouped_cross_attention (K3)      csrc/grouped_cross_attention.cu      models/layers.py:236-264
beam_topk (K4)                    csrc/beam_topk.cu                    layers.py:458-472, beam.py
supermask_weights (K5)            csrc/supermask.cu                    ops/masked.py:70-82, ops/ste.py:51-64
add_ref_layernorm (K6)            csrc/add_ref_layernorm.cu            models/layers.py:71-92,135-143
box_attention_train (K1 + K7)     csrc/box_attention_bwd.cu            gradients of layers.py:338-439
keyed_keep_mask (K8)              csrc/keyed_dropout.cu                models/layers.py:31-68 TimeDropout
keyed_dropout (K8 apply)          csrc/keyed_dropout.cu                models/layers.py:31-68 TimeDropout
sample_step (K9)                  csrc/sample_step.cu                  decoding/sample.py:134-159, layers.py:465-472
cider_reward (K10)                csrc/cider_reward.cu                 scst/device_reward.py:282-403
lstm_cell (K11)                   csrc/lstm_cell.cu                    models/up_down.py:47-54
additive_attention (K12)          csrc/additive_attention.cu           models/up_down.py:67-73
vocab_log_softmax (K13)           csrc/vocab_log_softmax.cu            up_down.py:124, layers.py:465-472
decoder_attention (K14)           csrc/decoder_attention.cu            models/layers.py:158-172,217-228
decoder_attention (K15 bwd)       csrc/decoder_attention_bwd.cu        gradients of layers.py:158-172
magnitude_masks (K16)             csrc/magnitude_threshold.cu          pruning/engine.py:210-257
ancestry_self_attention (K2 bwd)  csrc/ancestry_self_attention_bwd.cu  gradient of layers.py:317-320
grouped_cross_attention (K3 bwd)  csrc/grouped_cross_attention_bwd.cu  gradient of layers.py:249-264
supermask_weights (K5 keyed)      csrc/supermask.cu                    decoding/api.py:78-87 (mask draws)
sample_step (K9 gumbel, top-k,    csrc/sample_step.cu                  decoding/sample.py:29-90
nucleus modes)
beam_topk (K4 diverse)            csrc/beam_topk.cu                    decoding/beam.py:176-184
box_attention[_train] raw (K1)    csrc/box_attention.cu                models/layers.py:338-365 (raw geometry)
box_attention_bwd raw (K7)        csrc/box_attention_bwd.cu            gradients of the same
ancestry_self_attention (K2 bwd,  csrc/ancestry_self_attention_bwd    gradient of layers.py:320-333
ancestry mode)                    _anc.cu                              (through ancestry_onehot)
scheduled_sample (K9 ss mode)     csrc/sample_step.cu                  models/up_down.py:170-183
ancestry_self_attention (K2 bwd,  csrc/ancestry_self_attention_bwd.cu  gradient of layers.py:296,305-310
kv modes; dk 32, 13)                                                   (one cache read as K and V)
grouped_cross_attention (K3 bwd,  csrc/grouped_cross_attention_bwd.cu  gradient of layers.py:244-248
kv mode; dk 32, 13)                                                    (mem_v=None)
================================  ===================================  =============================================

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel (built at first use, see ``_build``) or raises. K1, K2,
K3, K7, K14 and K15 have kv modes (``*_kv`` entry points, their own launch
counts): an ACORT kv-shared layer passes one tensor as K and V. The six
attention kernels take head widths 64, 32 and 13 (``_checks.HEAD_WIDTHS``;
13 staged at 16). K5, K6,
K1/K7, K8's apply variant, K11-K13 and K14/K15 are autograd Functions whose
backward is a kernel too, and so are K2 and K3 where gradients are asked
for (supermask and beam-sample SCST's gradient pass; f32, head widths 64,
32 and 13, unshared or in their kv modes: ``*_bwd_kv`` entry points with
launch counts of their own). K5's
keyed mode draws its uniforms in the kernel from Philox (supermask SCST).
K9's sample methods (Gumbel, top-k, nucleus), K4's diverse-beam penalty and
K1 / K7 on the raw 4-wide geometry (``--no_box_trigonometric_embedding``)
are modes of the same entry points with launch counts of their own
(``sample_step_*``, ``beam_topk_diverse``, ``*_raw``). K2's backward through
the beam-ancestry map (beam-sample SCST) and K9's scheduled-sampling mode
(Up-Down's XE forward with ``ss_prob > 0``) are entry points of their own
(``ancestry_self_attention_bwd_anc``, ``scheduled_sample``).
"""

from sparse_caption_tpu_torch.kernels import add_ref_layernorm as _k6
from sparse_caption_tpu_torch.kernels import additive_attention as _k12
from sparse_caption_tpu_torch.kernels import ancestry_self_attention as _k2
from sparse_caption_tpu_torch.kernels import beam_topk as _k4
from sparse_caption_tpu_torch.kernels import box_attention as _k1
from sparse_caption_tpu_torch.kernels import box_attention_bwd as _k7
from sparse_caption_tpu_torch.kernels import grouped_cross_attention as _k3
from sparse_caption_tpu_torch.kernels import cider_reward as _k10
from sparse_caption_tpu_torch.kernels import decoder_attention as _k14
from sparse_caption_tpu_torch.kernels import keyed_dropout as _k8
from sparse_caption_tpu_torch.kernels import lstm_cell as _k11
from sparse_caption_tpu_torch.kernels import magnitude_threshold as _k16
from sparse_caption_tpu_torch.kernels import sample_step as _k9
from sparse_caption_tpu_torch.kernels import supermask as _k5
from sparse_caption_tpu_torch.kernels import vocab_log_softmax as _k13
from sparse_caption_tpu_torch.kernels._build import build_all  # noqa: F401

# entry point -> CudaKernel (launch counts live on these objects)
KERNELS = {
    "box_attention": _k1.KERNEL,
    "box_attention_train": _k1.KERNEL_TRAIN,
    "box_attention_kv": _k1.KERNEL_KV,
    "box_attention_train_kv": _k1.KERNEL_TRAIN_KV,
    "box_attention_raw": _k1.KERNEL_RAW,
    "box_attention_train_raw": _k1.KERNEL_TRAIN_RAW,
    "box_attention_kv_raw": _k1.KERNEL_KV_RAW,
    "box_attention_train_kv_raw": _k1.KERNEL_TRAIN_KV_RAW,
    "ancestry_self_attention": _k2.KERNEL,
    "ancestry_self_attention_kv": _k2.KERNEL_KV,
    "ancestry_self_attention_bwd": _k2.KERNEL_BWD,
    "ancestry_self_attention_bwd_anc": _k2.KERNEL_BWD_ANC,
    "ancestry_self_attention_bwd_kv": _k2.KERNEL_BWD_KV,
    "ancestry_self_attention_bwd_anc_kv": _k2.KERNEL_BWD_ANC_KV,
    "grouped_cross_attention": _k3.KERNEL,
    "grouped_cross_attention_kv": _k3.KERNEL_KV,
    "grouped_cross_attention_bwd": _k3.KERNEL_BWD,
    "grouped_cross_attention_bwd_kv": _k3.KERNEL_BWD_KV,
    "beam_topk": _k4.KERNEL,
    "beam_topk_diverse": _k4.KERNEL_DIVERSE,
    "supermask": _k5.KERNEL,
    "supermask_keyed": _k5.KERNEL_KEYED,
    "supermask_bwd": _k5.KERNEL_BWD,
    "add_ref_layernorm": _k6.KERNEL,
    "add_ref_layernorm_bwd": _k6.KERNEL_BWD,
    "box_attention_bwd": _k7.KERNEL,
    "box_attention_bwd_kv": _k7.KERNEL_KV,
    "box_attention_bwd_raw": _k7.KERNEL_RAW,
    "box_attention_bwd_kv_raw": _k7.KERNEL_KV_RAW,
    "keyed_keep_mask": _k8.KERNEL,
    "keyed_dropout": _k8.KERNEL_APPLY,
    "sample_step": _k9.KERNEL,
    "sample_step_gumbel": _k9.KERNEL_GUMBEL,
    "sample_step_topk": _k9.KERNEL_TOPK,
    "sample_step_nucleus": _k9.KERNEL_NUCLEUS,
    "scheduled_sample": _k9.KERNEL_SS,
    "cider_reward": _k10.KERNEL,
    "lstm_cell": _k11.KERNEL,
    "lstm_cell_bwd": _k11.KERNEL_BWD,
    "additive_attention": _k12.KERNEL,
    "additive_attention_bwd": _k12.KERNEL_BWD,
    "vocab_log_softmax": _k13.KERNEL,
    "vocab_log_softmax_bwd": _k13.KERNEL_BWD,
    "decoder_attention": _k14.KERNEL,
    "decoder_attention_kv": _k14.KERNEL_KV,
    "decoder_attention_bwd": _k14.KERNEL_BWD,
    "decoder_attention_bwd_kv": _k14.KERNEL_BWD_KV,
    "magnitude_threshold": _k16.KERNEL,
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}

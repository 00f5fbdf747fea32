"""Model registry of the port (names mirror ``sparse_caption_tpu.models``).

Model API (``device`` defaults to ``"cuda"``):

* ``model(att_feats, att_masks, seqs, boxes)``                     -> XE log-probs (eval)
* ``model(att_feats, att_masks, seqs, boxes, train=True, rng=r)``  -> XE log-probs with
  gradients, dropout and fresh supermask samples (``r``: ``ops.rng.TrainRandom``)
* ``model.encode(att_feats, att_masks, boxes)``                     -> memory dict
* ``model.init_cache(memory, max_steps, rows_per_image, ...)``      -> decode cache dict
* ``model.decode_step(it, cache, t, memory)``                       -> (log-probs, cache)
* ``model.decode_step_logits(it, cache, t, memory)``                -> (logits, cache)
* ``model.decode_teacher_forced(memory, seqs)``                     -> log-probs of seqs[:, 1:]

Train-mode decoding (the SCST sampling phase) passes ``train=True`` and the
decode's ``ops.rng.KeyedStream`` to ``init_cache`` and the decode steps;
``decode_teacher_forced(memory, seqs, train=True, rng=stream)`` replays it.
"""

from sparse_caption_tpu_torch.registry import Registry

MODEL_REGISTRY: Registry = Registry("model")
register_model = MODEL_REGISTRY.register


def get_model(name: str):
    MODEL_REGISTRY.import_all("sparse_caption_tpu_torch.models")
    return MODEL_REGISTRY.get(name.lower())

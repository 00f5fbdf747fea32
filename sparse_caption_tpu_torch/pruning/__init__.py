"""Pruning method taxonomy (parity: reference ``sparse_caption/pruning/prune.py:17-42``)."""

MASK_FREEZE = "mask_freeze"
REGULAR = "supermask"

MAG_BLIND = "mag_blind"
MAG_UNIFORM = "mag_uniform"
MAG_DIST = "mag_dist"

MAG_GRAD_BLIND = "mag_grad_blind"
MAG_GRAD_UNIFORM = "mag_grad_uniform"
MAG_GRAD_DIST = "mag_grad_dist"

LOTTERY_MAG_BLIND = "lottery_mag_blind"
LOTTERY_MAG_UNIFORM = "lottery_mag_uniform"
LOTTERY_MAG_DIST = "lottery_mag_dist"
LOTTERY_MASK_FREEZE = "lottery_mask_freeze"

SNIP = "snip"

SUPER_MASKS = (REGULAR,)
MAG_ANNEAL = (MAG_GRAD_BLIND, MAG_GRAD_UNIFORM)
MAG_HARD = (MAG_BLIND, MAG_UNIFORM, MAG_DIST)
LOTTERY = (LOTTERY_MAG_BLIND, LOTTERY_MAG_UNIFORM, LOTTERY_MAG_DIST, LOTTERY_MASK_FREEZE)
MAG_PRUNE_MASKS = MAG_HARD + MAG_ANNEAL + LOTTERY + (SNIP,)
VALID_MASKS = SUPER_MASKS + MAG_PRUNE_MASKS + (MASK_FREEZE,)

# masks that are themselves trained by gradient descent
TRAINABLE_MASKS = SUPER_MASKS + (SNIP,)

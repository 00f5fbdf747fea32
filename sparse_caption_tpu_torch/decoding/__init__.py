from sparse_caption_tpu_torch.decoding.penalties import penalty_fn  # noqa: F401
from sparse_caption_tpu_torch.decoding.beam import beam_search  # noqa: F401
from sparse_caption_tpu_torch.decoding.api import generate  # noqa: F401
from sparse_caption_tpu_torch.decoding.sample import sample_decode  # noqa: F401

"""Place recognition: the flat bag-of-binary-words vocabulary and the
keyframe index (port of mageslam_tpu/bow). Word assignment is one (N, V)
Hamming matrix (`ops/hamming.hamming_matrix`, `csrc/hamming.cu` on the
card) and an argmin; training is a batched Hamming k-medoid."""

from .index import (  # noqa: F401
    BowIndex,
    add_keyframe,
    compute_idf,
    empty_index,
    grow_index,
    query_keyframes,
    retrain_index,
)
from .vocab import train_vocabulary  # noqa: F401

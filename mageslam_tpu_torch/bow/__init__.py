"""Place recognition: the flat bag-of-binary-words vocabulary and the
keyframe index (port of mageslam_tpu/bow). Word assignment and each
iteration of the batched Hamming k-medoid training are one launch of
`csrc/bow_words.cu` on the card (`ops/bow_words.py`)."""

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

"""BoW keyframe index: per-keyframe word histograms (port of
mageslam_tpu/bow/index.py; OnlineBow's inverted index). Node weight = IDF
from the training counts, image vector = L1-normalized sum of its words'
weights (OnlineBow.cpp:26-28, 161-190, 391-392).

Every function returns a new index and reads nothing back to the host.
Word assignment is one `ops/bow_words.assign` call however many images it
covers (one `csrc/bow_words.cu` launch on the card, no (K·N, V) matrix in
memory): `image_vectors` takes a batch of images and assigns all their
descriptors at once. Histograms are one-hot sums in torch, a fixed
summation order (a scatter-add, or atomics in a kernel, would sum the
float weights in atomic order).
`query_keyframes` scores a query image against every indexed keyframe at
once (relocalization and loop detection).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bow_words
from ..ops.hamming import WORDS


class BowIndex(NamedTuple):
    anchors: torch.Tensor      # (V, 8) int32 vocabulary (uint32 bits)
    idf: torch.Tensor          # (V,) f32 word weights
    kf_vectors: torch.Tensor   # (K, V) f32 L1-normalized tf-idf histograms
    kf_has: torch.Tensor       # (K,) bool: keyframe present in the index
    trained: torch.Tensor      # () bool

    @property
    def num_words(self) -> int:
        return self.anchors.shape[0]


def empty_index(max_keyframes: int, num_words: int = 64, device=None) -> BowIndex:
    return BowIndex(
        anchors=torch.zeros((num_words, WORDS), dtype=torch.int32, device=device),
        idf=torch.ones((num_words,), dtype=torch.float32, device=device),
        kf_vectors=torch.zeros((max_keyframes, num_words), dtype=torch.float32,
                               device=device),
        kf_has=torch.zeros((max_keyframes,), dtype=torch.bool, device=device),
        trained=torch.tensor(False, device=device),
    )


def grow_index(index: BowIndex, max_keyframes: int) -> BowIndex:
    """Pad the per-keyframe rows to a larger keyframe capacity (with the
    map's bank growth); the vocabulary does not depend on it."""
    K = index.kf_has.shape[0]
    if max_keyframes < K:
        raise ValueError(f"grow_index: {max_keyframes} < {K} keyframes")
    pad = max_keyframes - K
    if pad == 0:
        return index
    return index._replace(
        kf_vectors=torch.nn.functional.pad(index.kf_vectors, (0, 0, 0, pad)),
        kf_has=torch.nn.functional.pad(index.kf_has, (0, pad)))


def assign_words(index: BowIndex, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., N) int32 word of each descriptor (..., N, 8), -1 where invalid:
    one `bow_words.assign` call over all of them (the first minimum)."""
    word = bow_words.assign(desc.reshape(-1, WORDS).contiguous(),
                            valid.reshape(-1).contiguous(), index.anchors)
    return word.reshape(valid.shape)


def _word_sums(word: torch.Tensor, weight: torch.Tensor, num_words: int) -> torch.Tensor:
    """(..., V) sums of `weight` (..., N) per word (-1: none)."""
    onehot = torch.nn.functional.one_hot(torch.clamp_min(word, 0).to(torch.int64),
                                         num_words).to(torch.float32)
    return torch.sum(onehot * torch.where(word >= 0, weight, 0.0)[..., None], dim=-2)


def image_vectors(index: BowIndex, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., V) L1-normalized tf-idf histograms of images (..., N, 8)."""
    word = assign_words(index, desc, valid)
    hist = _word_sums(word, index.idf[torch.clamp_min(word, 0).to(torch.int64)],
                      index.num_words)
    s = hist.sum(-1, keepdim=True)
    return hist / torch.where(s > 0, s, 1.0)


def compute_idf(index: BowIndex, training_desc: torch.Tensor,
                training_valid: torch.Tensor) -> BowIndex:
    """IDF from the training pool: ln(N_total / N_word); a word never seen
    gets the largest weight, ln(N_total)."""
    word = assign_words(index, training_desc, training_valid)
    counts = _word_sums(word, torch.ones_like(word, dtype=torch.float32), index.num_words)
    total = torch.clamp_min(counts.sum(), 1.0)
    idf = torch.log(total / torch.clamp_min(counts, 1.0))
    return index._replace(idf=torch.where(counts > 0, idf, torch.log(total)))


def add_keyframe(index: BowIndex, slot, desc: torch.Tensor, valid: torch.Tensor) -> BowIndex:
    """OnlineBow::AddImage: record the keyframe's histogram in `slot` (an
    int or a 0-d tensor; a negative slot changes nothing)."""
    vec = image_vectors(index, desc, valid)
    slot = torch.as_tensor(slot, dtype=torch.int64, device=vec.device).reshape(1)
    ok = slot >= 0
    s = torch.where(ok, slot, 0)
    return index._replace(
        kf_vectors=index.kf_vectors.index_put(
            (s,), torch.where(ok[:, None], vec[None], index.kf_vectors[s])),
        kf_has=index.kf_has.index_put((s,), index.kf_has[s] | ok))


def retrain_index(index: BowIndex, pool_desc: torch.Tensor, pool_valid: torch.Tensor,
                  kf_desc: torch.Tensor, kf_kp_valid: torch.Tensor, kf_has: torch.Tensor,
                  draws: torch.Tensor, iterations: int = 12) -> BowIndex:
    """Retrain the vocabulary from the accumulated pool (M, 8) and recompute
    the IDF and every indexed keyframe's histogram (kf_desc (K, N, 8),
    kf_kp_valid (K, N), kf_has (K,)) under it. draws (M,) Gumbel noise."""
    from .vocab import train_vocabulary

    anchors = train_vocabulary(pool_desc, pool_valid, draws, num_words=index.num_words,
                               iterations=iterations)
    index = index._replace(anchors=anchors, trained=torch.ones_like(index.trained))
    index = compute_idf(index, pool_desc, pool_valid)
    vecs = image_vectors(index, kf_desc, kf_kp_valid)
    return index._replace(kf_vectors=torch.where(kf_has[:, None], vecs, index.kf_vectors))


def remove_keyframes(index: BowIndex, removed: torch.Tensor) -> BowIndex:
    """Drop culled keyframes from the index."""
    return index._replace(kf_has=index.kf_has & ~removed)


def query_keyframes(index: BowIndex, desc: torch.Tensor, valid: torch.Tensor,
                    exclude: torch.Tensor | None = None,
                    qualifying_score: float = 0.75):
    """OnlineBow::QueryUnknownImage (OnlineBow.cpp:153-260): similarity
    sum(min(k, q)) of the query image against every indexed keyframe.
    Returns (scores (K,), qualified (K,) bool): the keyframes scoring at
    least max score · qualifying_score (BagOfWordsSettings.
    QualifyingCandidateScore), none where every score is 0."""
    q = image_vectors(index, desc, valid)
    scores = torch.sum(torch.minimum(index.kf_vectors, q[None, :]), dim=1)
    ok = index.kf_has if exclude is None else index.kf_has & ~exclude
    scores = torch.where(ok, scores, 0.0)
    max_score = torch.max(scores)
    qualified = ok & (scores >= max_score * qualifying_score) & (max_score > 0)
    return scores, qualified

"""Online vocabulary training: batched Hamming k-medoid (port of
mageslam_tpu/bow/vocab.py; OnlineBow::CreateVocabularyTree, gated by
BagOfWordsSettings: TrainingFrames = 15, MaxTrainingIteration = 12,
MinTrainingSize = 1000).

  assign: word(d) = argmin_v popcount(d ^ anchor_v)
  update: anchor_v = bitwise majority of its members  (256 bit votes)

One iteration is `ops/bow_words.vocab_step`: one `csrc/bow_words.cu`
launch on the card, its plain version on the CPU.

Descriptors are (·, 8) int32 bit views of the reference's uint32 words.
The reference draws the initial anchors from `jax.random.gumbel`; here the
(N,) draw is an input.
"""

from __future__ import annotations

import torch

from ..ops.bow_words import vocab_step


def train_vocabulary(descriptors: torch.Tensor, valid: torch.Tensor, draws: torch.Tensor,
                     num_words: int = 64, iterations: int = 12) -> torch.Tensor:
    """descriptors (N, 8) int32 training pool, valid (N,), draws (N,)
    Gumbel noise. Returns (num_words, 8) int32 anchor descriptors. Each
    iteration is one `vocab_step` (one `csrc/bow_words.cu` launch on the
    card)."""
    g = draws + torch.where(valid, 0.0, -1e9)
    init_idx = torch.sort(-g, stable=True).indices[:num_words]   # argsort(-g), stable
    anchors = descriptors[init_idx]
    for _ in range(iterations):
        anchors = vocab_step(descriptors, valid, anchors)
    return anchors

"""Online vocabulary training: batched Hamming k-medoid (port of
mageslam_tpu/bow/vocab.py; OnlineBow::CreateVocabularyTree, gated by
BagOfWordsSettings: TrainingFrames = 15, MaxTrainingIteration = 12,
MinTrainingSize = 1000).

  assign: word(d) = argmin_v popcount(d ^ anchor_v)   (one (N, V) matrix)
  update: anchor_v = bitwise majority of its members  (256 bit votes)

Descriptors are (·, 8) int32 bit views of the reference's uint32 words.
The reference draws the initial anchors from `jax.random.gumbel`; here the
(N,) draw is an input.
"""

from __future__ import annotations

import torch

from ..ops.hamming import WORDS, hamming_matrix

BIG = 1 << 20


def descriptor_bits(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 words → (N, 256) float32 0/1 bits, bit b of word w at
    32 w + b (shifted as int64, so the sign bit is bit 31 and no more)."""
    shifts = torch.arange(32, device=desc.device)
    bits = (desc.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 32 * WORDS).to(torch.float32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(V, 256) 0/1 → (V, 8) int32 words with the same bits (bit 31 the sign)."""
    shifts = torch.arange(32, device=bits.device)
    words = torch.sum(bits.to(torch.int64).reshape(-1, WORDS, 32) << shifts, dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def majority_descriptors(bits: torch.Tensor, member: torch.Tensor) -> torch.Tensor:
    """Bitwise majority over each word's members: bits (N, 256) from
    `descriptor_bits`, member (N, V) bool → (V, 8) int32. A bit is set when
    at least half the members set it (an empty word counts 1 member)."""
    m = member.to(torch.float32)
    votes = m.T @ bits               # (V, 256), exact: counts < 2^24, TF32 off
    count = torch.clamp_min(m.sum(0), 1.0)
    return pack_bits(votes * 2 >= count[:, None])


def train_vocabulary(descriptors: torch.Tensor, valid: torch.Tensor, draws: torch.Tensor,
                     num_words: int = 64, iterations: int = 12) -> torch.Tensor:
    """descriptors (N, 8) int32 training pool, valid (N,), draws (N,)
    Gumbel noise. Returns (num_words, 8) int32 anchor descriptors. Each
    iteration is one `hamming_matrix` call (a kernel launch on the card)."""
    g = draws + torch.where(valid, 0.0, -1e9)
    init_idx = torch.sort(-g, stable=True).indices[:num_words]   # argsort(-g), stable
    anchors = descriptors[init_idx]
    bits = descriptor_bits(descriptors)
    for _ in range(iterations):
        d = hamming_matrix(descriptors, anchors)
        d = torch.where(valid[:, None], d, BIG)
        word = torch.argmin(d, dim=1)                                  # first minimum
        member = torch.nn.functional.one_hot(word, num_words).to(torch.bool) \
            & valid[:, None]
        new_anchors = majority_descriptors(bits, member)
        # empty clusters keep their anchor
        anchors = torch.where(member.any(0)[:, None], new_anchors, anchors).contiguous()
    return anchors

"""`match_two_way_plain`, the plain version of the fused two-way match
kernel, against JAX `match_two_way` on seeded numpy inputs: exact, with ties
in both directions, empty rows and columns, and the batched form against a
loop of single calls. (The kernel itself is held against the plain version
on the card: tests/test_torch_cuda.py, chip_smoke.py.)"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mageslam_tpu.ops.matching import match_two_way as jmatch_two_way
from mageslam_tpu_torch.ops import matching

# the suite runs several worker processes on few cores: a small thread pool
# each costs less than the default of one thread a core
torch.set_num_threads(2)

# few distinct words with close popcounts: distances tie often
LOW_ENTROPY = np.array([0, 1, 3, 0x80000000, 0x80000003, 0xFFFF0000], np.uint32)


def make_case(seed, n_batch, n_a, n_b, low_entropy, valid_share=0.8):
    rng = np.random.RandomState(seed)
    if low_entropy:
        a = LOW_ENTROPY[rng.randint(0, 6, (n_batch, n_a, 8))]
        b = LOW_ENTROPY[rng.randint(0, 6, (n_batch, n_b, 8))]
    else:
        a = rng.randint(0, 2**32, (n_batch, n_a, 8), dtype=np.uint64).astype(np.uint32)
        b = rng.randint(0, 2**32, (n_batch, n_b, 8), dtype=np.uint64).astype(np.uint32)
        k = min(n_a, n_b) // 2                      # near copies: real matches
        b[:, :k] = a[:, :k] ^ (1 << rng.randint(0, 32, (n_batch, k, 8))).astype(np.uint32)
    return a, rng.rand(n_batch, n_a) < valid_share, b, rng.rand(n_batch, n_b) < valid_share


def jax_loop(a, va, b, vb, max_hamming, min_diff):
    out = [jmatch_two_way(jnp.asarray(a[i]), jnp.asarray(va[i]), jnp.asarray(b[i]),
                          jnp.asarray(vb[i]), max_hamming, min_diff)
           for i in range(a.shape[0])]
    return (np.stack([np.asarray(o[0]) for o in out]),
            np.stack([np.asarray(o[1]) for o in out]))


def torch_args(a, va, b, vb):
    return (torch.from_numpy(a.view(np.int32)), torch.from_numpy(va),
            torch.from_numpy(b.view(np.int32)), torch.from_numpy(vb))


@pytest.mark.parametrize("min_diff", [1, 8])
@pytest.mark.parametrize("n_a,n_b", [(1, 1), (33, 65), (128, 96)])
@pytest.mark.parametrize("low_entropy", [False, True])
def test_plain_equals_jax(low_entropy, n_a, n_b, min_diff):
    max_hamming = 6 if low_entropy else 45
    case = make_case(n_a * 131 + n_b + min_diff, 3, n_a, n_b, low_entropy)
    want_idx, want_dist = jax_loop(*case, max_hamming, min_diff)
    idx, dist = matching.match_two_way(*torch_args(*case), max_hamming, min_diff)
    assert idx.dtype == torch.int32 and idx.shape == (3, n_a)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(dist.numpy(), want_dist)
    if low_entropy and n_a > 1:
        assert (want_idx >= 0).any() and (want_idx < 0).any()


def test_ties_take_the_first_minimum_both_ways():
    # rows 0 and 1 of A are equal and both equal columns 0 and 1 of B: the
    # forward best of each row is column 0, whose best row is row 0, and
    # the second-best equals the best, so the gate passes only at min_diff 0
    a = np.zeros((1, 3, 8), np.uint32)
    b = np.zeros((1, 3, 8), np.uint32)
    a[0, 2], b[0, 2] = 0xFFFFFFFF, 0xFFFFFFFF
    ones = np.ones((1, 3), bool)
    for min_diff, want in ((0, [0, -1, 2]), (1, [-1, -1, 2])):
        idx, dist = matching.match_two_way(*torch_args(a, ones, b, ones), 300, min_diff)
        j_idx, j_dist = jax_loop(a, ones, b, ones, 300, min_diff)
        assert idx[0].tolist() == want == j_idx[0].tolist()
        assert dist[0].tolist() == j_dist[0].tolist()


def test_rows_and_columns_without_candidates():
    a, va, b, vb = make_case(7, 2, 40, 40, True)
    va[0, :] = False                 # an entry with no valid row
    vb[1, :] = False                 # an entry with no valid column
    for max_hamming in (6, 0):
        idx, dist = matching.match_two_way(*torch_args(a, va, b, vb), max_hamming, 1)
        j_idx, j_dist = jax_loop(a, va, b, vb, max_hamming, 1)
        np.testing.assert_array_equal(idx.numpy(), j_idx)
        np.testing.assert_array_equal(dist.numpy(), j_dist)
    assert (idx.numpy() == -1).all()


def test_batch_equals_a_loop_of_single_calls_and_shared_desc_a():
    a, va, b, vb = make_case(11, 5, 64, 80, False)
    ta, tva, tb, tvb = torch_args(a, va, b, vb)
    idx, dist = matching.match_two_way(ta, tva, tb, tvb, 45, 8)
    for i in range(5):
        s_idx, s_dist = matching.match_two_way(ta[i], tva[i], tb[i], tvb[i], 45, 8)
        assert s_idx.shape == (64,)
        torch.testing.assert_close(idx[i], s_idx, rtol=0, atol=0)
        torch.testing.assert_close(dist[i], s_dist, rtol=0, atol=0)
    # one (N, 8) bank shared by all entries
    shared_idx, shared_dist = matching.match_two_way(ta[0], tva, tb, tvb, 45, 8)
    a_rep = np.repeat(a[:1], 5, 0)
    j_idx, j_dist = jax_loop(a_rep, va, b, vb, 45, 8)
    np.testing.assert_array_equal(shared_idx.numpy(), j_idx)
    np.testing.assert_array_equal(shared_dist.numpy(), j_dist)
    assert (j_idx >= 0).sum() > 10


@pytest.mark.parametrize("n_a,n_b", [(0, 5), (5, 0)])
def test_empty_side_matches_nothing(n_a, n_b):
    a, va, b, vb = make_case(3, 2, n_a, n_b, True)
    idx, dist = matching.match_two_way(*torch_args(a, va, b, vb), 45, 1)
    assert idx.shape == (2, n_a) and (idx == -1).all() and (dist == -1).all()

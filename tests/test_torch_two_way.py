"""`match_two_way_plain`, the plain version of the fused two-way match
kernel, against JAX `match_two_way` on seeded numpy inputs: exact, with ties
in both directions, empty rows and columns, and the batched form against a
loop of single calls. (The kernel itself is held against the plain version
on the card: tests/test_torch_cuda.py, chip_smoke.py.)"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

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


def popcount_matrix(a, b):
    """(N, M) Hamming distances of uint32 (N, 8) and (M, 8) words, numpy."""
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(-1).astype(np.int64)


def merge(run, other):
    """The kernel's merge of two running (best, idx, second) over disjoint
    columns: lower distance, then lower index; second = min(winner's second,
    loser's best)."""
    (b, i, s), (ob, oi, os_) = run, other
    take = (ob < b) | ((ob == b) & (oi < i))
    return (np.where(take, ob, b), np.where(take, oi, i),
            np.minimum(np.where(take, os_, s), np.where(take, b, ob)))


def scan_model(q_desc, q_valid, t_desc, t_valid, max_hamming, chunk=256, splits=4):
    """The scan kernel's order of work for one direction, in numpy: chunks
    of `chunk` targets whose valid ones are compacted in index order;
    8-column tiles dealt in turn to the `splits` warps of a row group; lane
    t of a warp sees columns 2t and 2t + 1 of each of its tiles, in index
    order, keeping (best, idx, second) (a later equal distance becomes the
    second); the quad's lanes merge (xor 1, then xor 2), then warp 0 merges
    the others in order. Returns the records (idx, best, second) per query
    row."""
    big = matching.BIG
    d = popcount_matrix(q_desc, t_desc)
    d = np.where(q_valid[:, None] & (d <= max_hamming), d, big)
    n_q = d.shape[0]
    state = {(h, t): (np.full(n_q, big), np.zeros(n_q, np.int64), np.full(n_q, big))
             for h in range(splits) for t in range(4)}
    for base in range(0, t_desc.shape[0], chunk):
        cols = base + np.flatnonzero(t_valid[base:base + chunk])    # compacted, in order
        for tile in range((cols.size + 7) // 8):
            for t in range(4):
                for i in range(2):
                    k = 8 * tile + 2 * t + i
                    if k >= cols.size:
                        continue
                    b, j, s = state[(tile % splits, t)]
                    dk = d[:, cols[k]]
                    better = dk < b
                    state[(tile % splits, t)] = (np.where(better, dk, b),
                                            np.where(better, cols[k], j),
                                            np.where(better, b, np.minimum(s, dk)))
    warps = []
    for h in range(splits):
        lanes = [state[(h, t)] for t in range(4)]
        lanes = [merge(lanes[t], lanes[t ^ 1]) for t in range(4)]
        lanes = [merge(lanes[t], lanes[t ^ 2]) for t in range(4)]
        warps.append(lanes[0])
    run = warps[0]
    for other in warps[1:]:
        run = merge(run, other)
    best, idx, second = run
    return idx, best, second


def gate_model(fwd, bwd, min_diff):
    big = matching.BIG

    def side_ok(r):
        return (r[1] < big) & ((r[2] >= big) | (r[2] - r[1] >= min_diff))

    col = fwd[0]
    ok = side_ok(fwd) & side_ok(bwd)[col] & (bwd[0][col] == np.arange(col.size))
    return np.where(ok, col, -1), np.where(ok, fwd[1], -1)


@pytest.mark.parametrize("n_a,n_b,chunk,low_entropy", [
    (33, 530, 256, True),      # chunk boundaries at 256 and 512
    (129, 65, 16, True),       # many small chunks: ties across their edges
    (40, 300, 8, False),       # one tile a chunk, real matches
])
def test_scan_model_equals_plain_and_jax(n_a, n_b, chunk, low_entropy):
    """The kernel's compaction, column split and merges give the plain
    version's records and matches: held against `_best_and_second` on the
    masked matrix and against JAX `match_two_way`."""
    a, va, b, vb = make_case(n_a + n_b + chunk, 1, n_a, n_b, low_entropy, valid_share=0.5)
    a, va, b, vb = a[0], va[0], b[0], vb[0]
    max_hamming, min_diff = (6, 1) if low_entropy else (45, 8)
    fwd = scan_model(a, va, b, vb, max_hamming, chunk)
    bwd = scan_model(b, vb, a, va, max_hamming, chunk)
    d = torch.from_numpy(popcount_matrix(a, b).astype(np.int32))
    d = torch.where(torch.from_numpy(va[:, None] & vb[None, :]) & (d <= max_hamming), d,
                    matching.BIG)
    for got, dist in ((fwd, d), (bwd, d.T.contiguous())):
        want = matching._best_and_second(dist)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
    idx, dist_out = gate_model(fwd, bwd, min_diff)
    # JAX at one padded shape for every case (one compile): the padding rows
    # and columns are invalid, so they match nothing and change no match
    pad = [np.zeros((1, 129, 8), np.uint32), np.zeros((1, 129), bool),
           np.zeros((1, 530, 8), np.uint32), np.zeros((1, 530), bool)]
    for p, x in zip(pad, (a, va, b, vb)):
        p[0, :x.shape[0]] = x
    j_idx, j_dist = jax_loop(*pad, max_hamming, min_diff)
    np.testing.assert_array_equal(idx, j_idx[0, :n_a])
    np.testing.assert_array_equal(dist_out, j_dist[0, :n_a])
    if low_entropy:     # the case reaches ties at best in both directions
        assert (fwd[2] == fwd[1]).any() and (bwd[2] == bwd[1]).any()

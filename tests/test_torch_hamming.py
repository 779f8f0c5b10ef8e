"""The port's Hamming kernel module and matchers against the JAX package.

On the CPU the port's `hamming_matrix` is its plain PyTorch version; it is
held exactly against the Pallas kernel (interpret mode) and both JAX forms
(SWAR and bf16 bit-matmul). The CUDA kernel against the plain version runs
only where a GPU is present: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mageslam_tpu.ops import matching as jmatch
from mageslam_tpu.ops.pallas_kernels import hamming_matrix_pallas
from mageslam_tpu_torch.ops import hamming, matching

torch.set_num_threads(2)


def full_range_words(rng, rows):
    """(rows, 8) uint32 words over the whole range, bit 31 included."""
    return rng.randint(0, 2**32, size=(rows, 8), dtype=np.uint64).astype(np.uint32)


def as_torch(words):
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("n,m", [(1, 1), (128, 256), (129, 257), (200, 300)])
def test_hamming_matrix_matches_jax(rng, n, m):
    a, b = full_range_words(rng, n), full_range_words(rng, m)
    assert (a >= 2**31).any() and (b >= 2**31).any()
    got = hamming.hamming_matrix(as_torch(a), as_torch(b)).numpy()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(
        got, np.asarray(hamming_matrix_pallas(ja, jb, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jmatch.hamming_matrix(ja, jb, False)))
    np.testing.assert_array_equal(got, np.asarray(jmatch.hamming_matrix(ja, jb, True)))


def test_popcount_full_range():
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xAAAAAAAA,
                      0x55555555, 0x80000001], np.uint32)
    got = hamming.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    want = [bin(int(w)).count("1") for w in words]
    np.testing.assert_array_equal(got, want)


def test_dedup_by_target_matches_jax(rng):
    q = 300
    idx = rng.randint(-1, 60, q).astype(np.int32)
    dist = rng.randint(0, 8, q).astype(np.int32)        # many ties
    got = matching.dedup_by_target(torch.from_numpy(idx), torch.from_numpy(dist))
    want = jmatch.dedup_by_target(jnp.asarray(idx), jnp.asarray(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).sum() > 10


@pytest.mark.parametrize("octave_tol", [0, 1])
def test_radius_match_matches_jax(rng, octave_tol):
    nq, nt = 150, 120
    base = full_range_words(rng, nt)
    # queries: noisy copies of targets, so real matches exist
    src = rng.randint(0, nt, nq)
    flips = rng.rand(nq, 8, 32) < 0.04
    qd = base[src] ^ np.packbits(flips, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    qxy = rng.uniform(0, 100, (nq, 2)).astype(np.float32)
    txy = rng.uniform(0, 100, (nt, 2)).astype(np.float32)
    qo = rng.randint(0, 3, nq).astype(np.int32)
    to = rng.randint(0, 3, nt).astype(np.int32)
    qv = rng.rand(nq) > 0.1
    tv = rng.rand(nt) > 0.1
    radius = rng.uniform(5, 40, nq).astype(np.float32)
    got = matching.radius_match(
        as_torch(qd), torch.from_numpy(qxy), torch.from_numpy(qo), torch.from_numpy(qv),
        as_torch(base), torch.from_numpy(txy), torch.from_numpy(to), torch.from_numpy(tv),
        torch.from_numpy(radius), 60, 3, octave_tol=octave_tol)
    want = jmatch.radius_match(
        jnp.asarray(qd), jnp.asarray(qxy), jnp.asarray(qo), jnp.asarray(qv),
        jnp.asarray(base), jnp.asarray(txy), jnp.asarray(to), jnp.asarray(tv),
        jnp.asarray(radius), jnp.int32(60), jnp.int32(3), octave_tol=octave_tol)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[0].numpy() >= 0).sum() > 5


def test_match_two_way_matches_jax(rng):
    a = full_range_words(rng, 90)
    flips = rng.rand(90, 8, 32) < 0.05
    b = a ^ np.packbits(flips, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    b = b[rng.permutation(90)]
    va, vb = rng.rand(90) > 0.1, rng.rand(90) > 0.1
    got = matching.match_two_way(as_torch(a), torch.from_numpy(va), as_torch(b),
                                 torch.from_numpy(vb), 40, 2)
    want = jmatch.match_two_way(jnp.asarray(a), jnp.asarray(va), jnp.asarray(b),
                                jnp.asarray(vb), 40, 2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_cuda_tensor_never_takes_the_plain_path():
    """A CUDA tensor gets the kernel or an error: a CPU/CUDA mix raises
    instead of falling back (checked with a meta tensor, which needs no GPU)."""
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        hamming.hamming_matrix(a, torch.zeros((4, 8), dtype=torch.int32, device="meta"))


def test_tile_bit_order_is_a_permutation():
    assert sorted(hamming.tile_bit_order().tolist()) == list(range(256))


@pytest.mark.parametrize("n,m", [(1, 1), (33, 17), (64, 129)])
def test_pm_bits_product_is_the_hamming_matrix(rng, n, m):
    """The tensor-core tile's ±1 int8 expansion, in its K order: the dot
    product is 256 - 2 * Hamming, equal to the plain version and to JAX."""
    a, b = full_range_words(rng, n), full_range_words(rng, m)
    pa, pb = hamming.pm_bits(as_torch(a)), hamming.pm_bits(as_torch(b))
    assert pa.dtype == torch.int8 and pa.shape == (n, 256)
    assert set(pa.unique().tolist()) <= {-1, 1}
    dot = pa.to(torch.int32) @ pb.to(torch.int32).T
    got = ((256 - dot) // 2).numpy()
    np.testing.assert_array_equal(got, hamming.hamming_matrix_plain(as_torch(a), as_torch(b)).numpy())
    # JAX at one padded shape for every case: one compile
    pad_a, pad_b = np.zeros((64, 8), np.uint32), np.zeros((129, 8), np.uint32)
    pad_a[:n], pad_b[:m] = a, b
    want = jmatch.hamming_matrix(jnp.asarray(pad_a), jnp.asarray(pad_b), False)
    np.testing.assert_array_equal(got, np.asarray(want)[:n, :m])

"""The port's bag-of-words vocabulary and keyframe index
(mageslam_tpu_torch/bow) against the JAX functions on the same seeded
numpy inputs, with the JAX key's Gumbel draw injected.

Tolerances: anchors (descriptor words), word assignments and `kf_has`
exact; `idf` within 1e-6 (float32 log); histograms within 1e-6 (the same
float32 terms summed in another order). Descriptors mix random words with
near and exact copies of a few, so that distances tie at the argmin and
majority votes tie at half.
"""

import torch_threads  # noqa: F401  (first: torch's OpenMP threads wait passively)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mageslam_tpu.bow import index as jindex
from mageslam_tpu.bow import vocab as jvocab
from mageslam_tpu_torch.bow import index as tindex
from mageslam_tpu_torch.bow import vocab as tvocab
from mageslam_tpu_torch.ops import bow_words

torch.set_num_threads(2)

FIXTURE = "tests/data/torch_port_bench640_init.npz"
V = 16
ATOL = 1e-6


def words(seed: int, n: int) -> np.ndarray:
    """(n, 8) uint32: a third random, the rest copies of 12 seeds with a
    few bits flipped (or none)."""
    rng = np.random.RandomState(seed)
    out = rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)
    seeds = out[:12].copy()
    k = np.arange(n) % 3 != 0
    flips = (rng.rand(int(k.sum()), 8, 32) < 0.03)
    mask = np.packbits(flips, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    out[k] = seeds[rng.randint(0, 12, int(k.sum()))] ^ mask
    return out


def t_of(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.view(np.int32) if a.dtype == np.uint32
                                                 else a))


def vocab_draw(key, n: int) -> np.ndarray:
    return np.asarray(jax.random.gumbel(key, (n,)), np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_train_vocabulary_exact(seed):
    desc = words(seed, 256)
    valid = np.random.RandomState(seed + 10).rand(256) < 0.85
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jvocab.train_vocabulary(jnp.asarray(desc), jnp.asarray(valid), key,
                                              num_words=V, iterations=4))
    got = tvocab.train_vocabulary(t_of(desc), t_of(valid), t_of(vocab_draw(key, 256)),
                                  num_words=V, iterations=4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_majority_descriptor_bits():
    desc = words(2, 64)
    member = np.random.RandomState(3).rand(64, 3) < 0.5
    member[:, 2] = False                                  # an empty word
    bits = bow_words.descriptor_bits(t_of(desc))
    got = bow_words.majority_descriptors(bits, torch.from_numpy(member)).numpy().view(np.uint32)
    for v in range(3):
        want = np.asarray(jvocab._majority_descriptor(jnp.asarray(desc),
                                                       jnp.asarray(member[:, v])))
        np.testing.assert_array_equal(got[v], want)
    np.testing.assert_array_equal(bow_words.pack_bits(bits).numpy(), t_of(desc).numpy())


def copies(seed: int, n: int) -> np.ndarray:
    """`words` with every other row an exact copy of row 0 and every fifth
    of row 1: distances tie at the argmin, and a vocabulary drawn from the
    rows holds repeated anchors, whose later copies no row joins."""
    out = words(seed, n)
    out[::2] = out[0]
    out[1::5] = out[1]
    return out


@pytest.mark.parametrize("case", ["ties", "all-invalid", "empty-word"])
def test_vocab_step_plain_is_one_jax_step(case):
    """`bow_words.vocab_step` (its plain version here) from the anchors the
    JAX key's Gumbel draw picks is JAX's train_vocabulary with one
    iteration: exact."""
    n = 200
    desc = copies(60, n) if case != "ties" else words(60, n)
    valid = np.random.RandomState(61).rand(n) < 0.85
    if case == "all-invalid":
        valid[:] = False
    key = jax.random.PRNGKey(62)
    want = np.asarray(jvocab.train_vocabulary(jnp.asarray(desc), jnp.asarray(valid), key,
                                              num_words=V, iterations=1))
    g = vocab_draw(key, n) + np.where(valid, 0.0, -1e9).astype(np.float32)
    anchors = desc[np.argsort(-g, kind="stable")[:V]]
    got = bow_words.vocab_step(t_of(desc), t_of(valid), t_of(anchors))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    word = bow_words.assign(t_of(desc), t_of(valid), t_of(anchors)).numpy()
    empty = sorted(set(range(V)) - set(word[valid].tolist()))
    if case == "empty-word":      # an anchor no row joins keeps its descriptor
        assert empty and (got.numpy().view(np.uint32)[empty] == anchors[empty]).all()
    if case == "all-invalid":
        assert (word == -1).all() and (got.numpy().view(np.uint32) == anchors).all()


@pytest.mark.parametrize("seed", [70, 71])
def test_assign_plain_matches_jax_with_ties(seed):
    """`bow_words.assign` against JAX assign_words where distances tie (rows
    and anchors repeated): the first minimum, -1 where invalid."""
    desc = copies(seed, 300)
    anchors = desc[np.random.RandomState(seed).permutation(300)[:V]]
    valid = np.random.RandomState(seed + 1).rand(300) < 0.8
    got = bow_words.assign(t_of(desc), t_of(valid), t_of(anchors)).numpy()
    j = jindex.BowIndex(anchors=jnp.asarray(anchors), idf=jnp.ones(V, jnp.float32),
                        kf_vectors=jnp.zeros((2, V), jnp.float32), kf_has=jnp.zeros(2, bool),
                        trained=jnp.asarray(True))
    want = np.asarray(jindex.assign_words(j, jnp.asarray(desc), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert len(set(anchors.view(np.int32)[:, 0].tolist())) < V     # repeated anchors: ties


def test_bow_kernels_never_take_the_plain_path_off_the_cpu():
    """A tensor that is not on the CPU gets the kernel or an error (a meta
    tensor needs no GPU)."""
    desc, valid, anchors = t_of(words(80, 64)), torch.ones(64, dtype=torch.bool), \
        t_of(words(81, V))
    for fn in (bow_words.assign, bow_words.vocab_step):
        with pytest.raises(ValueError):
            fn(desc.to("meta"), valid, anchors)


def test_adoption_vocabulary_of_the_benchmark(request):
    """The JAX session's vocabulary at adoption, from its pool (the anchor
    frame's and the adopted frame's descriptors) and its recorded draw."""
    with np.load(FIXTURE) as z:
        a = int(z["init_n_attempt"]) - 1
        desc = np.concatenate([z[f"init_att{a}_desc1"], z[f"init_att{a}_desc2"]])
        valid = np.concatenate([z["init_third0_anchor_valid"], z[f"init_att{a}_valid2"]])
        draws, want = z["init_vocab0_draws"], z["init_bow_adopt_anchors"]
        want_idf = z["init_bow_adopt_idf"]
    got = tvocab.train_vocabulary(t_of(desc), t_of(valid), t_of(draws), num_words=64)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    index = tindex.empty_index(8)._replace(anchors=got)
    idf = tindex.compute_idf(index, t_of(desc), t_of(valid)).idf.numpy()
    np.testing.assert_allclose(idf, want_idf, rtol=0, atol=ATOL)


def jax_index(index: tindex.BowIndex) -> jindex.BowIndex:
    return jindex.BowIndex(*(jnp.asarray(t.numpy().view(np.uint32) if f == "anchors"
                                         else t.numpy())
                             for f, t in zip(index._fields, index)))


def assert_index_equal(got: tindex.BowIndex, want: jindex.BowIndex) -> None:
    np.testing.assert_array_equal(got.anchors.numpy().view(np.uint32), np.asarray(want.anchors))
    np.testing.assert_allclose(got.idf.numpy(), np.asarray(want.idf), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.kf_vectors.numpy(), np.asarray(want.kf_vectors), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(got.kf_has.numpy(), np.asarray(want.kf_has))
    assert bool(got.trained) == bool(want.trained)


@pytest.fixture(scope="module")
def trained():
    """A trained index over 6 keyframe slots, the same in both packages."""
    desc = words(4, 256)
    valid = np.random.RandomState(5).rand(256) < 0.9
    anchors = words(6, V)
    t = tindex.empty_index(6, num_words=V)._replace(anchors=t_of(anchors),
                                                    trained=torch.tensor(True))
    t = tindex.compute_idf(t, t_of(desc), t_of(valid))
    j = jindex.compute_idf(jax_index(t)._replace(idf=jnp.ones(V, jnp.float32)),
                           jnp.asarray(desc), jnp.asarray(valid))
    return t, j, desc, valid


def test_compute_idf(trained):
    t, j, _, _ = trained
    assert_index_equal(t, j)
    assert (t.idf.numpy() > 0).all()


def test_assign_words_first_minimum_wins(trained):
    t, j, desc, valid = trained
    got = tindex.assign_words(t, t_of(desc), t_of(valid)).numpy()
    want = np.asarray(jindex.assign_words(j, jnp.asarray(desc), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    # batched images assign like one call per image
    both = tindex.assign_words(t, t_of(desc.reshape(4, 64, 8)), t_of(valid.reshape(4, 64)))
    np.testing.assert_array_equal(both.numpy().reshape(-1), want)


@pytest.mark.parametrize("slot", [0, 3, -1])
def test_add_keyframe(trained, slot):
    t, j, _, _ = trained
    desc, valid = words(7, 64), np.random.RandomState(8).rand(64) < 0.8
    t2 = tindex.add_keyframe(t, slot, t_of(desc), t_of(valid))
    j2 = jindex.add_keyframe(j, jnp.int32(slot), jnp.asarray(desc), jnp.asarray(valid))
    assert_index_equal(t2, j2)
    assert bool(t2.kf_has.any()) == (slot >= 0)


def test_retrain_index(trained):
    t, j, desc, valid = trained
    for s in (0, 2, 5):
        d, v = words(20 + s, 64), np.random.RandomState(30 + s).rand(64) < 0.8
        t = tindex.add_keyframe(t, s, t_of(d), t_of(v))
        j = jindex.add_keyframe(j, jnp.int32(s), jnp.asarray(d), jnp.asarray(v))
    kf_desc = np.stack([words(40 + k, 64) for k in range(6)])
    kf_valid = np.random.RandomState(9).rand(6, 64) < 0.85
    kf_has = np.array([True, False, True, False, False, True])
    key = jax.random.PRNGKey(3)
    want = jindex.retrain_index_jit(j, jnp.asarray(desc), jnp.asarray(valid),
                                    jnp.asarray(kf_desc), jnp.asarray(kf_valid),
                                    jnp.asarray(kf_has), key, iterations=4)
    got = tindex.retrain_index(t, t_of(desc), t_of(valid), t_of(kf_desc), t_of(kf_valid),
                               t_of(kf_has), t_of(vocab_draw(key, 256)), iterations=4)
    assert_index_equal(got, want)
    removed = np.array([False, False, True, False, False, False])
    assert_index_equal(tindex.remove_keyframes(got, torch.from_numpy(removed)),
                       jindex.remove_keyframes(want, jnp.asarray(removed)))


def test_grow_index(trained):
    t, j, _, _ = trained
    t = tindex.add_keyframe(t, 4, t_of(words(50, 64)), torch.ones(64, dtype=torch.bool))
    j = jindex.add_keyframe(j, jnp.int32(4), jnp.asarray(words(50, 64)), jnp.ones(64, bool))
    assert_index_equal(tindex.grow_index(t, 10), jindex.grow_index(j, 10))
    assert tindex.grow_index(t, 6) is t
    with pytest.raises(ValueError):
        tindex.grow_index(t, 5)

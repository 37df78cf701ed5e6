"""The port's ``pair_codes`` against the JAX package's.

``repro_torch.kernels.ops.pair_codes`` on CPU tensors (its plain version)
equals ``repro.kernels.pair_codes`` — the Pallas kernel in interpret
mode — and ``repro.kernels.pair_codes_ref`` on the same numpy tiles:
sorted unique keys at several hit rates, rows padded with -1, rows that
repeat a key (the codes of every equal key are summed), and codes that
wrap int32.  The tolerance is zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import pair_codes as ref_pair_codes
from repro.kernels import pair_codes_ref as ref_pair_codes_ref
from repro_torch.kernels import ops

torch.set_num_threads(1)


def sorted_tiles(rng, b, hit_rate):
    """(q, k, kc): sorted unique key rows with codes in {1, 2, 3}; a
    ``hit_rate`` share of queries equal a key of their row."""
    k = np.sort(np.stack([rng.choice(10_000, size=128, replace=False)
                          for _ in range(b)]), axis=1).astype(np.int32)
    kc = rng.integers(1, 4, size=(b, 128)).astype(np.int32)
    take = rng.random((b, 128)) < hit_rate
    q = np.where(take, k, -5 - rng.integers(0, 100, size=(b, 128)))
    return q.astype(np.int32), k, kc, take


def both(q, k, kc):
    """(port, reference Pallas in interpret mode, reference plain)."""
    got = ops.pair_codes(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(kc))
    assert got.dtype == torch.int32 and tuple(got.shape) == q.shape
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(kc))
    pallas = ref_pair_codes(*args, interpret=True)
    plain = jax.jit(ref_pair_codes_ref)(*args)
    return got.numpy(), np.asarray(pallas), np.asarray(plain)


@pytest.mark.parametrize("hit_rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("b", [1, 7, 8, 33])
def test_matches_reference(b, hit_rate):
    rng = np.random.default_rng(b * 17 + int(hit_rate * 10))
    q, k, kc, take = sorted_tiles(rng, b, hit_rate)
    got, pallas, plain = both(q, k, kc)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got[~take], 0)
    np.testing.assert_array_equal(got[take], np.take_along_axis(
        kc, np.argmax(q[:, :, None] == k[:, None, :], axis=2),
        axis=1)[take])


def test_padded_rows():
    """Short rows padded with -1 keys; queries of -1 match every pad
    slot, as in the reference."""
    rng = np.random.default_rng(3)
    q, k, kc, _ = sorted_tiles(rng, 9, 0.5)
    for row, live in enumerate((0, 1, 5, 64, 127, 128, 3, 0, 40)):
        k[row, live:] = -1
        kc[row, live:] = rng.integers(1, 4, 128 - live)
        q[row, rng.random(128) < 0.1] = -1
    got, pallas, plain = both(q, k, kc)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, plain)


def test_duplicate_keys_sum_and_wrap():
    """Rows repeat keys, unsorted: every equal key's code is summed, and
    large codes wrap in int32 as the reference's int32 sum does."""
    rng = np.random.default_rng(4)
    b = 5
    k = rng.integers(0, 6, size=(b, 128)).astype(np.int32)
    kc = rng.integers(-3, 4, size=(b, 128)).astype(np.int32)
    kc[0] = 2**30                     # 128 * 2**30 wraps
    kc[1] = -2**31
    q = rng.integers(-1, 7, size=(b, 128)).astype(np.int32)
    got, pallas, plain = both(q, k, kc)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, plain)
    assert (got != 0).any()


def test_rejects_bad_tiles():
    t = torch.zeros((4, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.pair_codes(t, t, torch.zeros((4, 64), dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.pair_codes(t, t.long(), t)
    with pytest.raises(ValueError):
        ops.pair_codes(t, t[:3], t)
    empty = torch.zeros((0, 128), dtype=torch.int32)
    assert ops.pair_codes(empty, empty, empty).shape == (0, 128)

"""The port's spatial hash against the JAX package's: fmix32 bit-exact, and
the find-or-insert contract (every distinct id resolves to a slot holding
it, no id twice in the table, failures counted under a tight probe bound).
Slots may differ from the JAX package's lane-order election, so the
comparisons are by id."""

import jax.numpy as jnp
import numpy as np
import torch

from hifi_fusion_tpu.ops import hashing as jhash
from hifi_fusion_tpu_torch.ops import hashing

RNG = np.random.default_rng(7)


def test_hash_u32_bit_exact():
    ids = np.concatenate([np.arange(1000, dtype=np.int32),
                          RNG.integers(0, 2 ** 31 - 1, 10000,
                                       dtype=np.int32),
                          np.asarray([2 ** 31 - 1, 0, 1], np.int32)])
    got = hashing.hash_u32(torch.from_numpy(ids)).numpy()
    want = np.asarray(jhash.hash_u32(jnp.asarray(ids))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def _insert(capacity_log2, n, max_probes, table=None):
    C = 1 << capacity_log2
    key = torch.full((C,), -1, dtype=torch.int32) if table is None \
        else table
    ids = torch.from_numpy(RNG.choice(2 ** 30, n, replace=False)
                           .astype(np.int32))
    slot, failed = hashing.lookup_or_insert(key, ids, max_probes, C)
    return key, ids, slot, int(failed)


def test_find_or_insert_resolves_every_id():
    key, ids, slot, failed = _insert(14, 6000, 32)
    assert failed == 0 and bool((slot >= 0).all())
    np.testing.assert_array_equal(key[slot.long()].numpy(), ids.numpy())
    used = key[key >= 0].numpy()
    assert used.size == ids.numel() == np.unique(used).size
    # the same ids again are found, not re-inserted, at the same slots
    again, failed2 = hashing.lookup_or_insert(key, ids, 32, 1 << 14)
    assert failed2 == 0
    np.testing.assert_array_equal(again.numpy(), slot.numpy())
    assert int((key >= 0).sum()) == used.size
    np.testing.assert_array_equal(
        hashing.lookup(key, ids, 32, 1 << 14).numpy(), slot.numpy())
    # a mix of present and new ids
    new = torch.from_numpy(np.setdiff1d(
        RNG.choice(2 ** 30, 500, replace=False), ids.numpy())
        .astype(np.int32))
    mix = torch.cat([ids[:300], new])
    s3, f3 = hashing.lookup_or_insert(key, mix, 32, 1 << 14)
    assert f3 == 0
    np.testing.assert_array_equal(s3[:300].numpy(), slot[:300].numpy())
    np.testing.assert_array_equal(key[s3.long()].numpy(), mix.numpy())


def test_probe_sequence_matches_jax():
    """Inserted into an empty table, an id's slot lies on the JAX
    package's probe sequence (fmix32 + triangular offsets)."""
    C = 1 << 12
    key, ids, slot, failed = _insert(12, 1500, 16)
    h = np.asarray(jhash.hash_u32(jnp.asarray(ids.numpy()))).astype(
        np.int64)
    j = np.arange(16)
    seq = (h[:, None] + (j * (j + 1) // 2)[None, :]) & (C - 1)
    placed = slot.numpy() >= 0
    assert np.all((seq[placed] == slot.numpy()[placed, None]).any(axis=1))
    # lookups through the JAX package's reader find the same slots
    jslot = np.asarray(jhash.lookup(jnp.asarray(key.numpy()),
                                    jnp.asarray(ids.numpy()),
                                    jnp.ones(ids.numel(), bool), 16, C))
    np.testing.assert_array_equal(jslot, slot.numpy())


def test_probe_bound_counts_failures():
    """capacity_log2=8, max_probes=8: an over-full table drops ids and
    counts each; every placed id still holds its slot."""
    key, ids, slot, failed = _insert(8, 300, 8)
    placed = slot >= 0
    assert failed == int((~placed).sum()) > 0
    np.testing.assert_array_equal(key[slot[placed].long()].numpy(),
                                  ids[placed].numpy())
    assert int((key >= 0).sum()) == int(placed.sum()) <= 256

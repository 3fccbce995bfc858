"""The port's spatial hash against the JAX package's: fmix32 bit-exact, and
the find-or-insert contract (every distinct id resolves to a slot holding
it, no id twice in the table, failures counted under a tight probe bound).
Slots may differ from the JAX package's lane-order election, so the
comparisons are by id."""

import jax.numpy as jnp
import numpy as np
import pytest
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


def test_counter_form_matches_returning_form():
    """With the caller's overflow counter the plain path returns the same
    slots and table as the returning form and adds the same failure count
    into the counter, on top of what it held."""
    C = 1 << 8
    ids = torch.from_numpy(RNG.choice(2 ** 30, 300, replace=False)
                           .astype(np.int32))
    base = torch.full((C,), -1, dtype=torch.int32)
    hashing.insert_plain(base, ids[:150], 8, C)
    k_ret, k_cnt = base.clone(), base.clone()
    slot, failed = hashing.lookup_or_insert(k_ret, ids, 8, C)
    counter = torch.tensor(5, dtype=torch.int32)
    slot_c = hashing.lookup_or_insert(k_cnt, ids, 8, C, counter)
    assert int(failed) > 0 and int(counter) == 5 + int(failed)
    assert counter.dtype == torch.int32 and counter.dim() == 0
    np.testing.assert_array_equal(slot_c.numpy(), slot.numpy())
    np.testing.assert_array_equal(k_cnt.numpy(), k_ret.numpy())
    # a second call adds again; no failures add nothing
    hashing.lookup_or_insert(k_cnt, ids, 8, C, counter)
    assert int(counter) == 5 + 2 * int(failed)
    big = torch.full((1 << 12,), -1, dtype=torch.int32)
    hashing.lookup_or_insert(big, ids, 32, 1 << 12, counter)
    assert int(counter) == 5 + 2 * int(failed)


def test_counter_form_rejects_bad_counters():
    key = torch.full((16,), -1, dtype=torch.int32)
    ids = torch.arange(4, dtype=torch.int32)
    for bad in (torch.zeros((), dtype=torch.int64),
                torch.zeros((1,), dtype=torch.int32)):
        with pytest.raises(ValueError):
            hashing.lookup_or_insert(key, ids, 8, 16, bad)


@pytest.mark.parametrize("max_probes", [32, 2])
def test_sentinel_lanes_vs_jax(max_probes):
    """K2's plain version on a budget-sized array whose INVALID_ID lanes
    hold no id (the integrate's run ids past U, the refine's non-start line
    lanes) against the JAX package's find-or-insert of the same ids with
    those lanes inactive: the same id set in the table, every id at a slot
    holding it, sentinel lanes -1, and the same failure count under a
    tight probe bound (a half-full 256-slot table)."""
    C = 1 << 8 if max_probes == 2 else 1 << 12
    ids = RNG.choice(2 ** 30, 200, replace=False).astype(np.int32)
    lanes = np.full(3 * ids.size, hashing.INVALID_ID, np.int32)
    lanes[1::3] = ids
    key = torch.full((C,), -1, dtype=torch.int32)
    slot, failed = hashing.lookup_or_insert(key, torch.from_numpy(lanes),
                                            max_probes, C)
    active = lanes != hashing.INVALID_ID
    jkey, jslot, jfailed = jhash.lookup_or_insert(
        jnp.full((C + lanes.size,), -1, jnp.int32), jnp.asarray(lanes),
        jnp.asarray(active), max_probes, C, unique_ids=True)
    slot, key = slot.numpy(), key.numpy()
    jslot, jkey = np.asarray(jslot), np.asarray(jkey)[:C]
    assert int(failed) == int(jfailed)
    assert (int(failed) > 0) == (max_probes == 2)
    assert (slot[~active] == -1).all()
    placed = slot >= 0
    np.testing.assert_array_equal(key[slot[placed]], lanes[placed])
    np.testing.assert_array_equal(placed[active], (jslot >= 0)[active])
    np.testing.assert_array_equal(np.sort(key[key >= 0]),
                                  np.sort(jkey[jkey >= 0]))


@pytest.mark.parametrize("n_live", [0, 150, 200])
def test_live_count_vs_jax(n_live):
    """K2's plain version on a budget-sized array whose ids are packed
    before a live count (the integrate's run ids) and whose lanes past it
    hold stale ids: only the lanes before the count are inserted, the rest
    get -1 and touch neither the table nor the failure count.  Against the
    JAX package's find-or-insert of the same lanes with the ones past the
    count inactive."""
    C = 1 << 12
    lanes = RNG.choice(2 ** 30, 400, replace=False).astype(np.int32)
    key = torch.full((C,), -1, dtype=torch.int32)
    slot, failed = hashing.lookup_or_insert(
        key, torch.from_numpy(lanes), 32, C,
        n_live=torch.tensor(n_live, dtype=torch.int32))
    active = np.arange(lanes.size) < n_live
    jkey, jslot, jfailed = jhash.lookup_or_insert(
        jnp.full((C + lanes.size,), -1, jnp.int32), jnp.asarray(lanes),
        jnp.asarray(active), 32, C, unique_ids=True)
    slot, key = slot.numpy(), key.numpy()
    jkey = np.asarray(jkey)[:C]
    assert int(failed) == int(jfailed) == 0
    assert (slot[~active] == -1).all() and (slot[active] >= 0).all()
    np.testing.assert_array_equal(key[slot[active]], lanes[active])
    np.testing.assert_array_equal(np.sort(key[key >= 0]),
                                  np.sort(jkey[jkey >= 0]))
    assert int((key >= 0).sum()) == n_live


def test_live_count_rejects_bad_counts():
    key = torch.full((16,), -1, dtype=torch.int32)
    ids = torch.arange(4, dtype=torch.int32)
    for bad in (torch.tensor(2, dtype=torch.int64),
                torch.tensor([2], dtype=torch.int32)):
        with pytest.raises(ValueError):
            hashing.lookup_or_insert(key, ids, 8, 16, n_live=bad)

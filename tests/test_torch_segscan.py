"""The port's segmented scan (ops/scatter.py, the plain version of kernel
T1) against the JAX package's ``segment_reduce``: bit-identical for every
kind, on flat (n <= 1024) and two-level (blocked, padded) sizes, with
flags that leave an empty run before the first segment, and on the
adversarial flag patterns of ``checks.segscan_case``.  Inputs are made
with numpy from a seed and handed to both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.ops import scatter as jscatter
from hifi_fusion_tpu_torch import checks
from hifi_fusion_tpu_torch.ops import scatter

JOPS = {"add": jnp.add, "first": lambda a, b: a, "or": jnp.bitwise_or}


@functools.partial(jax.jit, static_argnames=("kind",))
def _jax_reduce(values, starts, *, kind):
    """The JAX package's scan as the TSDF integrate runs it: inside jit."""
    return jscatter.segment_reduce(values, starts, JOPS[kind], kind=kind)


SIZES = (1, 300, 1024, 1536, 2000, 5 * 512 + 37)


def _inputs(kind, dtype, k, n, seed):
    rng = np.random.default_rng(seed)
    # an empty stretch before the first flag, then runs of 1-40 lanes
    starts = np.zeros(n, bool)
    i = int(rng.integers(0, min(n, 700)))
    while i < n:
        starts[i] = True
        i += int(rng.integers(1, 41))
    shape = (k, n)
    if kind == "or":
        vals = (np.int64(1) << rng.integers(0, 31, shape)).astype(np.int32)
        vals[:, rng.random(n) < 0.3] = 0
    elif dtype == np.int32:
        vals = rng.integers(-2 ** 31, 2 ** 31 - 1, shape, dtype=np.int32)
    else:
        vals = rng.normal(0.0, 3.0, shape).astype(np.float32)
        vals[:, rng.random(n) < 0.2] = np.float32(-0.0)
        vals[:, rng.random(n) < 0.1] = 0.0
    return vals, starts


def _both(kind, vals, starts, one_d):
    v = vals[0] if one_d else vals
    want = np.asarray(_jax_reduce(jnp.asarray(v), jnp.asarray(starts),
                                  kind=kind))
    got = scatter.segment_reduce(torch.from_numpy(v.copy()),
                                 torch.from_numpy(starts), kind).numpy()
    return got, want


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind,dtype,k", [
    ("add", np.float32, 1), ("add", np.float32, 6),
    ("first", np.float32, 2), ("first", np.int32, 1), ("or", np.int32, 3)])
def test_segment_reduce_bit_identical(kind, dtype, k, n):
    vals, starts = _inputs(kind, dtype, k, n, seed=n * 7 + k)
    got, want = _both(kind, vals, starts, one_d=(k == 1))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# n not a multiple of 512 (the last block is ragged), 39 blocks
ADV_N = 38 * 512 + 481


@pytest.mark.parametrize("pattern", checks.SEGSCAN_PATTERNS)
@pytest.mark.parametrize("kind,dtype,k", [
    ("add", np.float32, 6), ("first", np.float32, 2), ("first", np.int32, 1),
    ("or", np.int32, 3)])
def test_segment_reduce_adversarial_flags(pattern, kind, dtype, k):
    """Flag patterns that stress the two-level structure: segments over
    several blocks, flagless blocks, a late first flag, a ragged tail."""
    vals, starts = checks.segscan_case(pattern, kind, dtype, k, ADV_N,
                                       seed=k + len(pattern))
    got, want = _both(kind, vals, starts, one_d=(k == 1))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_segment_sums_fill_and_boundaries():
    """segment_sums ends hold each run's sum; segment_fill broadcasts the
    start value; starts / ends match the JAX package's."""
    rng = np.random.default_rng(5)
    keys = np.sort(rng.integers(0, 300, 3000)).astype(np.int32)
    keys[-200:] = np.iinfo(np.int32).max           # invalid tail
    valid = keys != np.iinfo(np.int32).max
    tk, tv = torch.from_numpy(keys), torch.from_numpy(valid)
    st = scatter.segment_starts(tk, tv)
    en = scatter.segment_ends(tk, tv)
    np.testing.assert_array_equal(st.numpy(), np.asarray(
        jscatter.segment_starts(jnp.asarray(keys), jnp.asarray(valid))))
    np.testing.assert_array_equal(en.numpy(), np.asarray(
        jscatter.segment_ends(jnp.asarray(keys), jnp.asarray(valid))))
    vals = np.where(valid, rng.integers(1, 9, keys.size), 0).astype(
        np.float32)
    sums = scatter.segment_sums(torch.from_numpy(vals), st).numpy()
    ukeys, counts = np.unique(keys[valid], return_counts=True)
    want = np.asarray([vals[keys == u].sum() for u in ukeys])
    np.testing.assert_array_equal(sums[en.numpy()], want)
    fill = scatter.segment_fill(torch.from_numpy(keys.copy()), st).numpy()
    np.testing.assert_array_equal(fill[valid], keys[valid])
    assert counts.sum() == valid.sum()


def test_segment_reduce_rejects_bad_inputs():
    v = torch.zeros(8)
    f = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        scatter.segment_reduce(v.to(torch.int32), f, "add")
    with pytest.raises(ValueError):
        scatter.segment_reduce(v, f, "max")
    with pytest.raises(ValueError):
        scatter.segment_reduce(torch.zeros(17, 8), f, "add")
    with pytest.raises(ValueError):
        scatter.segment_reduce(v, f[:4], "add")

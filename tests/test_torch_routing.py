"""Owner-slab routing (hifi_fusion_tpu_torch/parallel/routing.py) against
the JAX package's (hifi_fusion_tpu/parallel/routing.py), on the CPU:

* ``owner_of_x`` equal to the JAX function;
* ``route_sort_plain`` / ``pack_send_plain`` equal to JAX ``route_sort`` /
  ``pack_send`` lane for lane: targets, payload bits, ranks, lane
  validity, the largest bucket, the send buffer and the drop count, at n
  in {2, 4} on a frame with points in the halo bands, a frame in one
  slab, and a budget that drops;
* ``route_pack`` / ``route_pack_depth`` (kernel B12's wrapper, the plain
  pair on a CPU tensor) on K-frame batches of the planar and depth wires
  against JAX's stages run per frame and strided source block, with the
  JAX sharded pipeline's tier rule, their send buffers rearranged to the
  destinations' layout (JAX ``exchange_batch``'s receive lanes of every
  destination, stacked);
* ``exchange_batch`` on one device: views of ``route_pack``'s buffers (no
  copy), equal to the stack-and-slice of the send buffers it replaced;
* the send-budget tiers equal to those ``ShardedFusion`` computes;
* the narrow-slab refusal (as tests/test_routing.py:226).

Every comparison is exact: the routing arithmetic is the frontend's, in
the same operation order.  JAX ``route_sort`` runs op by op, as
tests/test_torch_integrate.py runs the JAX transform: inside ``jit`` XLA
on the CPU contracts the transform's multiply-adds into fused ones, which
moves ~6% of world coordinates by one ulp (the sharded tests hold those
within ``checks.py``'s tolerances), and op by op it divides by the
resolution where the port multiplies by its reciprocal as ``jit`` does,
which floors differently about once in a million coordinates and never in
these frames.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.ops.integrate import _unpack_inputs
from hifi_fusion_tpu.parallel import routing as jrouting
from hifi_fusion_tpu.parallel.sharding import ShardedFusion as JaxSharded
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.ops import geometry
from hifi_fusion_tpu_torch.parallel import routing
from hifi_fusion_tpu_torch.parallel.sharding import (ShardedFusion,
                                                     send_lanes_tiers,
                                                     shard_devices)

CFG = small_test_config()
JCFG = jax_config()
HALO = CFG.k_neighborhood + CFG.line_k + 1          # 6 cells
XDIM = CFG.global_x_cells                           # 64 cells


def _pose(rng):
    a = rng.uniform(-0.4, 0.4)
    pose = np.eye(4, dtype=np.float32)
    pose[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    pose[:3, 3] = rng.uniform(-0.02, 0.02, 3)
    return pose


def _frame(case, n, Nb, seed):
    """(3,Nb) camera points, (3,Nb) rgb, (Nb,) mask and a pose whose world
    points fall: in the halo bands of every slab boundary and anywhere
    (``halo``, ``drop``), or inside one slab's core (``concentrated``);
    5% of the lanes masked, a few outside the bbox."""
    rng = np.random.default_rng(seed)
    W = -(-XDIM // n)
    lo = CFG.bbox[0]
    res = CFG.resolution[0]
    if case == "concentrated":
        x = lo + res * rng.uniform(W + HALO + 0.5, 2 * W - HALO - 0.5, Nb)
    else:
        edge = rng.integers(1, n, Nb) * W + rng.uniform(-HALO - 1, HALO + 1,
                                                         Nb)
        x = lo + res * np.where(rng.random(Nb) < 0.6, edge,
                                rng.uniform(0, XDIM, Nb))
    world = np.stack([x, rng.uniform(-0.3, 0.3, Nb),
                      rng.uniform(-0.3, 0.3, Nb)])
    world[1:, rng.random(Nb) < 0.02] *= 1.2          # some outside the bbox
    pose = _pose(rng)
    R, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
    cam = (R.T @ (world - t[:, None])).astype(np.float32)
    rgb = rng.integers(0, 256, (3, Nb)).astype(np.float32)
    mask = rng.random(Nb) > 0.05
    return cam, rgb, mask, pose


@pytest.mark.parametrize("n", [2, 4, 8])
def test_owner_of_x(n):
    x = np.arange(-3, XDIM + 3, dtype=np.int32)
    W = -(-XDIM // n)
    got = routing.owner_of_x(torch.from_numpy(x), n, W).numpy()
    want = np.asarray(jrouting.owner_of_x(jnp.asarray(x), n, W))
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_stages():
    """JAX route_sort (op by op) and pack_send (jitted) per static
    argument set."""
    cache = {}

    def get(n, W, Bs=None):
        key = (n, W, Bs)
        if key not in cache:
            if Bs is None:
                cache[key] = partial(jrouting.route_sort, config=JCFG,
                                     n_dev=n, slab_w=W, halo=HALO)
            else:
                cache[key] = jax.jit(partial(jrouting.pack_send, n_dev=n,
                                             send_lanes=Bs))
        return cache[key]
    return get


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case,Bs", [("halo", 1024), ("concentrated", 2048),
                                     ("drop", 128)])
def test_route_sort_and_pack_match_jax(jax_stages, n, case, Bs):
    Nb = 1024
    W = -(-XDIM // n)
    cam, rgb, mask, pose = _frame(case, n, Nb, seed=11 * n + len(case))
    rs = routing.route_sort_plain(*map(torch.from_numpy,
                                       (cam, rgb, mask, pose)),
                                  CFG, n, W, HALO)
    jrs = jax_stages(n, W)(jnp.asarray(cam), jnp.asarray(rgb),
                           jnp.asarray(mask), jnp.asarray(pose))
    np.testing.assert_array_equal(rs.tgt.numpy(), np.asarray(jrs.tgt))
    np.testing.assert_array_equal(rs.payload.numpy().view(np.int32),
                                  np.asarray(jrs.payload).view(np.int32))
    np.testing.assert_array_equal(rs.rank.numpy(), np.asarray(jrs.rank))
    np.testing.assert_array_equal(rs.lvalid.numpy(), np.asarray(jrs.lvalid))
    assert rs.max_bucket == int(jrs.max_bucket) > 0
    # a halo copy is a kept lane sent to another shard than its x's owner
    own = routing.owner_of_x(geometry.cell_coords(rs.payload[:3], CFG)[0],
                             n, W)
    n_sec = int((rs.lvalid & (rs.tgt != own)).sum())
    if case == "concentrated":
        assert set(np.unique(rs.tgt.numpy()[rs.lvalid.numpy()])) == {1}
        assert n_sec == 0
    else:
        assert n_sec > 0                     # halo copies were made
    send, nd = routing.pack_send_plain(rs, n, Bs)
    jsend, jnd = jax_stages(n, W, Bs)(jrs)
    np.testing.assert_array_equal(send.numpy().view(np.int32),
                                  np.asarray(jsend).view(np.int32))
    assert nd == int(jnd)
    assert (nd > 0) == (case == "drop")


def _dest_major(send):
    """(K, n, 7, n*Bs) send buffers of every frame and source -> (n, K,
    7, n*Bs), destination j's lanes source-major: the lanes JAX
    ``exchange_batch`` (routing.py:175-185) gives destination j."""
    K, n, _, nb = send.shape
    return send.reshape(K, n, 7, n, nb // n).transpose(3, 0, 2, 1, 4
                                                       ).reshape(n, K, 7, nb)


def _assert_routed(got, want):
    """The port's ``Routed`` against JAX's (send, Bs, drop, max bucket):
    world and rgb bit for bit, present where channel 6 is 1."""
    recv = _dest_major(want[0])
    for t, ch in ((got.world, slice(0, 3)), (got.rgb, slice(3, 6))):
        np.testing.assert_array_equal(t.numpy().view(np.int32),
                                      recv[:, :, ch].view(np.int32))
    assert set(np.unique(recv[:, :, 6])) <= {0.0, 1.0}
    np.testing.assert_array_equal(got.present.numpy(), recv[:, :, 6] == 1)
    assert tuple(got[3:]) == want[1:]


def _jax_batch(cam, rgb, mask, poses, n, tiers, stages):
    """JAX's stages per frame and strided source block, the tier rule of
    the JAX sharded pipeline (sharding.py:302-308, :334-336)."""
    W = -(-XDIM // n)
    K = poses.shape[0]
    rss = [[stages(n, W)(cam[k][:, s::n], rgb[k][:, s::n], mask[k][s::n],
                         poses[k]) for s in range(n)] for k in range(K)]
    mx = max(int(r.max_bucket) for row in rss for r in row)
    ix = sum(int(mx > bs) for bs in tiers[:-1])
    Bs = tiers[ix]
    send = np.stack([np.stack([np.asarray(stages(n, W, Bs)(r)[0])
                               for r in row]) for row in rss])
    drop = sum(int(np.sum(np.asarray(r.lvalid) & (np.asarray(r.rank) >= Bs)))
               for row in rss for r in row)
    return send, Bs, drop, mx


@pytest.mark.parametrize("n,tiers", [(2, (256, 1024)), (4, (128, 384)),
                                     (4, (64,))])
def test_route_pack_planar_batch(jax_stages, n, tiers):
    K, N = 3, 1024
    fr = [_frame("halo" if k != 1 else "concentrated", n, N, seed=k + n)
          for k in range(K)]
    cam, rgb, mask, poses = (np.stack([f[i] for f in fr]) for i in range(4))
    W = -(-XDIM // n)
    got = routing.route_pack(*map(torch.from_numpy, (cam, rgb, mask, poses)),
                             CFG, n, W, HALO, tiers)
    want = _jax_batch(*map(jnp.asarray, (cam, rgb, mask, poses)), n, tiers,
                      jax_stages)
    _assert_routed(got, want)
    # the count-prefix mask form equals the bool lanes it stands for
    counts = np.array([N, N // 2, 300], np.int32)
    lanes = np.arange(N)[None, :] < counts[:, None]
    a = routing.route_pack(*map(torch.from_numpy, (cam, rgb, counts, poses)),
                           CFG, n, W, HALO, tiers)
    b = routing.route_pack(*map(torch.from_numpy, (cam, rgb, lanes, poses)),
                           CFG, n, W, HALO, tiers)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    assert a[3:] == b[3:]


def test_route_pack_depth_batch(jax_stages):
    """The depth wire, unprojected as the JAX routed depth step does
    (``_unpack_inputs`` of the batch, sharding.py:444-446)."""
    from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                       make_depth_sweep)
    cfg = small_test_config(z_clip=(0.05, 10.0))
    jcfg = jax_config(z_clip=(0.05, 10.0))
    rays = camera_rays(64, 64, fx=80.0, fy=80.0)
    frames = make_depth_sweep(cfg, 4, width=64, height=64, srays=rays,
                              seed=2, noise_sd=3e-4, camera_height=0.4)
    dq, r565 = (np.stack([getattr(f, a) for f in frames])
                for a in ("depth_q", "rgb565"))
    counts = np.array([f.count for f in frames], np.int32)
    counts[1] -= 700
    poses = np.stack([f.pose for f in frames])
    n, W = 4, -(-XDIM // 4)
    tiers = send_lanes_tiers(cfg.max_points, n, (2.0, 4.0))
    got = routing.route_pack_depth(*map(torch.from_numpy, (
        dq, r565, counts, poses, rays)), cfg, n, W, HALO, tiers)
    p, c, m = _unpack_inputs(jnp.asarray(dq), jnp.asarray(r565),
                             jnp.asarray(counts), None, jnp.asarray(rays))
    stages = {}

    def jstages(n_, W_, Bs=None):
        if (n_, W_, Bs) not in stages:
            stages[(n_, W_, Bs)] = (
                partial(jrouting.route_sort, config=jcfg, n_dev=n_,
                        slab_w=W_, halo=HALO) if Bs is None
                else jax.jit(partial(jrouting.pack_send, n_dev=n_,
                                     send_lanes=Bs)))
        return stages[(n_, W_, Bs)]
    want = _jax_batch(p, c, m, jnp.asarray(poses), n, tiers, jstages)
    _assert_routed(got, want)
    assert got.max_bucket > 0


@pytest.mark.parametrize("n,tiers", [(2, (256, 1024)), (4, (64,))])
def test_exchange_batch_views(n, tiers):
    """Destination j's lanes are the [j] views of ``route_pack``'s
    buffers (same storage, no copy on one device), equal to the
    stack-and-slice of the per-source send buffers that the exchange did
    before the kernel wrote the destinations' layout."""
    K, N = 2, 1024
    fr = [_frame("halo", n, N, seed=40 + k + n) for k in range(K)]
    cam, rgb, mask, poses = (torch.from_numpy(np.stack([f[i] for f in fr]))
                             for i in range(4))
    W = -(-XDIM // n)
    r = routing.route_pack(cam, rgb, mask, poses, CFG, n, W, HALO, tiers)
    Bs = r.send_lanes
    send = torch.stack([torch.stack([routing.pack_send_plain(
        routing.route_sort_plain(cam[k][:, s::n], rgb[k][:, s::n],
                                 mask[k][s::n], poses[k], CFG, n, W, HALO),
        n, Bs)[0] for s in range(n)]) for k in range(K)])
    devices = shard_devices("cpu", n)
    recv = routing.exchange_batch(r.world, r.rgb, r.present, devices)
    assert len(recv) == n
    for j, (w, c, p) in enumerate(recv):
        for got, full in ((w, r.world), (c, r.rgb), (p, r.present)):
            assert got.is_contiguous()
            assert got.data_ptr() == full[j].data_ptr()
            assert (got.untyped_storage().data_ptr()
                    == full.untyped_storage().data_ptr())
        old = torch.stack([send[:, s, :, j * Bs:(j + 1) * Bs]
                           for s in range(n)], dim=2).reshape(K, 7, n * Bs)
        assert torch.equal(w.view(torch.int32),
                           old[:, 0:3].contiguous().view(torch.int32))
        assert torch.equal(c.view(torch.int32),
                           old[:, 3:6].contiguous().view(torch.int32))
        assert torch.equal(p, old[:, 6] > 0.5)
        assert int(p.sum()) > 0


@pytest.mark.parametrize("N,n,betas", [(4096, 2, None), (4096, 4, None),
                                       (307_200, 4, None),
                                       (307_200, 8, (1.0, 2.0, 8.0)),
                                       (4096, 4, (0.05,))])
def test_send_budget_tiers_match_jax(N, n, betas):
    # 128 x cells at 5 mm, so that 8 slabs are wide enough to route
    over = dict(max_points=N, resolution=(0.005,) * 3)
    kw = {"route_betas": betas} if betas else {}
    jsf = JaxSharded(jax_config(**over), n_devices=n, route=True, **kw)
    sf = ShardedFusion(small_test_config(**over), shard_devices("cpu", n),
                       route=True, **kw)
    assert sf.send_lanes_tiers == jsf.send_lanes_tiers
    assert sf.config.max_points == jsf.config.max_points
    assert sf.config.max_active_points == jsf.config.max_active_points
    for mx in (0, 1, *sf.send_lanes_tiers, sf.send_lanes_tiers[-1] + 1):
        ix = routing.tier_index(sf.send_lanes_tiers, mx)
        assert ix == sum(int(mx > bs) for bs in jsf.send_lanes_tiers[:-1])
        assert sf.send_lanes_tiers[ix] >= mx or ix == len(
            sf.send_lanes_tiers) - 1


def test_narrow_slabs_raise():
    """n=8 on 64 x cells: slab_w 8 < 2*halo 12, refused with the JAX
    package's message."""
    msg = r"slab_w \(8\) >= 2\*halo \(12\)"
    with pytest.raises(ValueError, match=msg):
        ShardedFusion(CFG, shard_devices("cpu", 8), route=True)
    with pytest.raises(ValueError, match=msg):
        routing.check_slabs(8, HALO)
    cam, rgb, mask, pose = _frame("halo", 2, 64, seed=0)
    with pytest.raises(AssertionError, match=msg):
        jrouting.route_sort(jnp.asarray(cam), jnp.asarray(rgb),
                            jnp.asarray(mask), jnp.asarray(pose),
                            config=JCFG, n_dev=8, slab_w=8, halo=HALO)

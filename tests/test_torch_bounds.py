"""The byte and operation counts of ``hifi_fusion_tpu_torch/bounds.py``
against counts made by hand, at two shapes each, and the count helpers on
small hand-built inputs."""

import pytest
import torch

from hifi_fusion_tpu_torch import bounds


@pytest.mark.parametrize("k,n,per_lane", [(6, 27_033_600, 49), (1, 1000, 9)])
def test_segscan_bytes(k, n, per_lane):
    b = bounds.segscan(k, n)
    assert b["bytes"] == per_lane * n and b["ops"] == k * n
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(per_lane * n / 3.35e12 * 1e3)


@pytest.mark.parametrize("K,N", [(8, 307_200), (2, 100)])
def test_depth_frontend_bytes(K, N):
    # u16 depth + rgb565 in, world xyz + id + rgb out, per pixel; rays once,
    # and per frame an i32 count and a 4x4 f32 pose
    want = K * N * (2 + 2 + 12 + 4 + 12) + N * 12 + K * (4 + 64)
    assert bounds.depth_frontend(K, N)["bytes"] == want


@pytest.mark.parametrize("wire,K,N,want", [
    # f32 points and rgb, a bool mask: 12 + 12 + 1 in, 28 out a lane, a
    # pose a frame; 8 x 640x480 is the 130 MB of csrc/planar_frontend.cu
    ("f32", 8, 307_200, 8 * 307_200 * 53 + 8 * 64),
    # u16 points, packed u32 rgb, count prefixes: 6 + 4 in, 28 out a lane;
    # a pose, a (2,3) f32 quantization and an i32 count a frame
    ("q16", 8, 307_200, 8 * 307_200 * 38 + 8 * (64 + 24 + 4)),
    ("q16", 1, 10, 10 * 38 + 92)])
def test_planar_frontend_bytes(wire, K, N, want):
    kw = {} if wire == "f32" else dict(point_bytes=6, rgb_bytes=4,
                                       mask_bytes=0)
    b = bounds.planar_frontend(K, N, **kw)
    assert b["bytes"] == want and b["ops"] == 30 * K * N
    assert b["bound_by"] == "bytes"
    if (wire, K) == ("f32", 8):
        assert b["bytes"] == 130_253_312
        assert b["bound_ms"] == pytest.approx(0.03888, abs=1e-5)


@pytest.mark.parametrize("K,N,S", [(8, 307_200, 11), (1, 10, 3)])
def test_tsdf_lanes_bytes(K, N, S):
    want = K * N * 4 + N * 12 + K * 68 + K * N * S * (4 + 6 * 4)
    b = bounds.tsdf_lanes(K, N, S)
    assert b["bytes"] == want and b["ops"] == K * N * (40 + 12 * S)


@pytest.mark.parametrize("M,n_live,n_new,n_placed", [
    (27_033_600, 1_200_000, 600_000, 1_200_000), (1000, 0, 0, 0)])
def test_tsdf_reduce_bytes(M, n_live, n_new, n_placed):
    # per lane its sorted id, order word and six values through it; per
    # kept run its key probe, a new cell's key; per placed cell its six
    # vstats words read and written; the two counters
    want = 36 * M + 4 * n_live + 4 * n_new + 48 * n_placed + 8
    b = bounds.tsdf_reduce(M, n_live, n_new, n_placed)
    assert b["bytes"] == want and b["ops"] == 6 * (M + n_placed)
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("U,n_new", [(1000, 0), (60_000, 25_000)])
def test_hash_insert_bytes(U, n_new):
    assert bounds.hash_insert(U, n_new)["bytes"] == 12 * U + 4 * n_new + 4


def test_hash_insert_counts_by_hand():
    # 8 slots: 3 filled before; the call fills 2 more and finds 1
    before = torch.tensor([-1, 5, -1, 9, -1, -1, 2, -1], dtype=torch.int32)
    after = before.clone()
    after[0], after[5] = 11, 12
    c = bounds.hash_insert_counts(before, after)
    assert c == {"n_new": 2, "load_before": 3 / 8, "load_after": 5 / 8}


@pytest.mark.parametrize("shape,n,n_new", [
    # the three call shapes of the seeded bench sweep's third batch
    ("integrate", 148_816, 6_059),
    ("refine", 64_820, 21_655),
    ("tsdf", 1_244_811, 63_724)])
def test_hash_insert_shapes_by_hand(shape, n, n_new):
    # per id: the id read, one table word read, its slot written; per new
    # id its table word written; the failure count
    b = bounds.hash_insert(n, n_new)
    want = n * 4 + n * 4 + n * 4 + n_new * 4 + 4
    assert b["bytes"] == want and b["ops"] == 0
    assert b["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)


@pytest.mark.parametrize("E", [1, 208_326])
def test_tsdf_surface_bytes(E):
    assert bounds.tsdf_surface(E)["bytes"] == E * 148


def test_bound_by_operations():
    # 1 B and 67e9 operations: 1 ms of f32 work, ~3e-10 ms of bytes
    b = bounds.bound(1, int(67e9))
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1.0)


def test_dep_stream_counts_by_hand():
    D = 3
    # slots 0..3: cell 2 lists owners (0, -1, 1) with dep_count 5 (> D),
    # cell 3 lists owner 0 with dep_count 1; 4 lanes of cell 2, 2 unplaced
    # lanes, 3 lanes of cell 3
    dep = torch.full((4 * D,), -1, dtype=torch.int32)
    dep[2 * D:3 * D] = torch.tensor([0, -1, 1], dtype=torch.int32)
    dep[3 * D] = 0
    dep_count = torch.tensor([0, 0, 5, 1], dtype=torch.int32)
    slots = torch.tensor([2, 2, 2, 2, -1, -1, 3, 3, 3], dtype=torch.int32)
    hits = torch.tensor([7.0, 0.0, 0.0, 0.0])
    c = bounds.dep_stream_counts(slots, dep, dep_count, D, hits)
    assert c == {"n": 9, "n_cells": 2, "n_dep_words": 3 + 1, "n_owners": 2,
                 "n_hit_owners": 1, "n_pairs": 4 * 2 + 3 * 1}
    b = bounds.dep_stream(**c)
    assert b["bytes"] == 9 * 16 + 2 * 4 + 4 * 4 + 2 * 16 + 1 * 40
    assert b["ops"] == 20 * 11


@pytest.mark.parametrize("ids,words", [
    # one cell at (0, 0, 40) of a 4x4x64 grid, k=1: in-bounds columns
    # (x, y) in {0,1}^2 start at bit (x*4 + y)*64 + 39, in words 1, 3, 9,
    # 11, each with its next word
    ([40], {1, 2, 3, 4, 9, 10, 11, 12}),
    # two neighbours along z share all their words
    ([40, 41], {1, 2, 3, 4, 9, 10, 11, 12}),
])
def test_normal_fit_words_by_hand(ids, words):
    got = bounds.normal_fit_words(torch.tensor(ids, dtype=torch.int32),
                                  (4, 4, 64), 1, 32)
    assert got == len(words)


@pytest.mark.parametrize("K,N,S,mask_bytes,want", [
    # f32 points and colour, count prefixes: 24 B in a point, a pose and a
    # count a frame, 28 B out a sample lane; the config-5 batch is the
    # ~757 MB of lanes plus ~59 MB of planar input of csrc/tsdf_lanes.cu
    (8, 307_200, 11, 0, 8 * 307_200 * (24 + 11 * 28) + 8 * 68),
    # a bool mask: 1 B more a point, no count
    (2, 100, 5, 1, 2 * 100 * (25 + 5 * 28) + 2 * 64)])
def test_tsdf_lanes_planar_bytes(K, N, S, mask_bytes, want):
    b = bounds.tsdf_lanes_planar(K, N, S, mask_bytes)
    assert b["bytes"] == want and b["ops"] == K * N * (40 + 12 * S)
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("Q,live,words", [(1 << 22, 259_983, 2_000_000),
                                          (10, 0, 0)])
def test_neighbor_count_bytes(Q, live, words):
    # slot in and count out a query, a key a live query, each window word
    b = bounds.neighbor_count(Q, live, words)
    assert b["bytes"] == 8 * Q + 4 * live + 4 * words and b["ops"] == 0
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)


@pytest.mark.parametrize("wire,K,N,n,Bs,want", [
    # u16 depth + rgb565 a lane, the rays once, a count and a pose a frame;
    # world and rgb f32 and present 1 B a column of the destinations'
    # (n, K, n*Bs) lanes, padding included
    ("depth", 8, 307_200, 4, 38_400,
     8 * 307_200 * 4 + 307_200 * 12 + 8 * 68 + 4 * 8 * 4 * 38_400 * 25),
    # f32 points and rgb and a bool mask a lane, a pose a frame
    ("planar", 1, 1000, 2, 256, 1000 * 25 + 64 + 2 * 1 * 2 * 256 * 25)])
def test_route_pack_bytes(wire, K, N, n, Bs, want):
    b = bounds.route_pack(K, N, n, Bs, wire)
    assert b["bytes"] == want and b["ops"] == 30 * K * N
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("color", [True, False])
def test_integrate_lanes_bytes(color):
    # NA lanes: sid + i64 order read, sorted xyz + slot written (28 B);
    # valid lanes gather xyz (+ rgb); per cell key, n_pts r/w, normal_found
    # (+ rgb_sum r/w); new keys, first viewpoints, words r/w, appended lanes
    b = bounds.integrate_lanes(100, 80, 10, 3, 4, 2, 50, color)
    lane, cell = (24, 37) if color else (12, 13)
    assert b["bytes"] == (100 * 28 + 80 * lane + 10 * cell + 3 * 4 + 4 * 12
                          + 2 * 8 + 50 * 16)
    assert b["ops"] == 80 * (4 if color else 1)


def test_refine_lines_and_replay_bytes():
    b = bounds.refine_lines(1000, 900, 7, 3000, 1200, 5000)
    assert b["bytes"] == (1000 * 21 + 7000 * 4 + 3000 * 12 + 1200 * 4
                          + 5000 * 4)
    assert b["ops"] == 10 * 7 * 900
    r = bounds.buffer_replay(7000, 900, 20000, 30000, 800)
    assert r["bytes"] == 7000 * 4 + 900 * 20 + 20000 * 16 + 800 * 40
    assert r["ops"] == 20 * 30000
    y = bounds.buffer_replay_per_link(7000, 5000, 20000, 30000, 800)
    assert y["bytes"] == 7000 * 8 + 5000 * 20 + 20000 * 16 + 800 * 40
    assert y["ops"] == 20 * 30000


def test_buffer_replay_counts():
    # links to slots 3 (twice), 5 and 9 (no buffered point), two
    # unwritten, a candidate without a link
    links = torch.tensor([[3, 3], [5, -1], [-1, -1], [9, 9]],
                         dtype=torch.int32)
    bslot = torch.tensor([1, 3, 3, 3, 5, 7], dtype=torch.int32)
    hits = torch.tensor([0.0, 2.0, 0.0, 1.0])
    assert bounds.buffer_replay_counts(links, bslot, hits) == {
        "P": 8, "n_links": 5, "n_owners": 3, "n_points": 4, "n_pairs": 7,
        "n_hit_owners": 2}


def test_launcher_signatures_match_sources():
    """Every ``launch_*`` entry point of ``csrc/*.cu`` has the ctypes
    argument list ``kernels`` binds it with: a pointer where the C side
    takes one, else int, long or float in order (a mismatch passes a
    wrong value to a kernel that cannot be built here)."""
    import ctypes
    import re
    from hifi_fusion_tpu_torch import kernels
    src = "".join(p.read_text() for p in sorted(kernels.CSRC.glob("*.cu")))
    decls = dict(re.findall(r'extern "C" int (launch_\w+)\(([^)]*)\)', src))
    assert set(decls) == set(kernels._SIGNATURES)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "int",
             ctypes.c_long: "long", ctypes.c_float: "float"}
    for name, argtypes in kernels._SIGNATURES.items():
        params = [p.split() for p in decls[name].split(",")]
        got = ["p" if "*" in " ".join(p) else p[-2] for p in params]
        assert got == [kinds[a] for a in argtypes], name


def test_scan_tiles_mirror_sources():
    """The tile sizes and the look-back scratch the wrappers allocate
    (``kernels.RUN_SCAN_TILE``, ``kernels.B3_TILE``,
    ``kernels.lookback_words``) are the ones ``csrc`` declares: a smaller
    allocation would let the scans write past the scratch on the card."""
    import re
    from hifi_fusion_tpu_torch import kernels
    scan = (kernels.CSRC / "scan.cuh").read_text()
    b3 = (kernels.CSRC / "integrate_lanes.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    threads = const(scan, "SCAN_THREADS")
    assert kernels.RUN_SCAN_TILE == const(scan, "RUN_SCAN_ITEMS") * threads
    assert kernels.B3_TILE == const(b3, "B3_ITEMS") * threads
    assert "return 2 * (1 + 2L * grid_blocks(n, tile));" in scan
    for n, tile, tiles in ((0, 512, 1), (512, 512, 1), (513, 512, 2),
                           (2_457_600, 4096, 600)):
        assert kernels.lookback_words(n, tile) == 2 * (1 + 2 * tiles)

"""Where the count flips between the port's extract and the C++ oracle come
from.

The port floors a world point to its cell as ``floor((p - origin) *
inv_res)``, with ``inv_res`` the folded f32 reciprocal, as the JAX
package's compiled programs do; the C++ oracle floors ``(p - origin) /
res``.  A point within an ulp of a cell face can land in neighbouring
cells under the two forms (a "face point"), and its hits then go to
different owners' cylinders.  The ulp of the floor's argument grows with
the cell index, so the share of face points grows with the distance from
the grid's lower corner.

For each scene the sweep goes through a one-grid session, and the C++
oracle through the same frames at the session's cadence.  Printed per
scene: voxels, count flips, total hits, face
points, the flips within reach of a face point's cells (Chebyshev
distance ``line_k + 1`` or less) beside the share of all voxels in that
reach, and then the same for the sweep with the face
points' pixels blanked (depth 0) on both sides.  Scenes:

* ``bench``: the bench config's seed-0 sweep (``chip_smoke.py`` phase 9);
* ``bench_far``: the same frames on a grid whose lower corner is 1.4 m
  lower in x and y (cell indices 1400-2100 where ``bench`` has 0-700):
  the same world points, the same cell faces, larger floor arguments;
* ``flagship`` and ``flagship_s1``: the launch-file extent's sweep
  (``chip_smoke.py`` phase 15), seeds 0 and 1, on its one-grid cut of the
  same lower corner, whose extract the 8 shards equal exactly.

    python3 oracle_flips.py                    # on the card, 96 frames
    python3 oracle_flips.py --device cpu --frames 8 --width 160 --height 120

The last line is the results as one JSON object; ``--out PATH`` writes
them there too.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BENCH_FAR_BBOX = (-1.75, 0.35, -1.75, 0.35, 0.0, 0.4)


def scene(torch, name, grid_cfg, frames, rays_np, dev, card):
    """One scene, whole and blanked: the counts the module docstring
    lists."""
    rows = {}
    for tag, fr in (("whole", frames),
                    ("blanked", cs.blank_faces(frames, grid_cfg))):
        with tempfile.TemporaryDirectory(prefix="oracle_flips_") as tmp:
            r = cs.replay(torch, grid_cfg, fr, rays_np, dev, tmp)[0]
            cs.check_outputs(r)
        host = r["host"]
        problems, info = cs.oracle_sweep(grid_cfg, fr, host, card,
                                         phase=f"{name}/{tag}")
        every = cs.near_faces(host["cell"], cs.face_cells(fr, grid_cfg),
                              grid_cfg)
        rows[tag] = {
            "voxels": int(host["cell"].size),
            "count_flips": int(info["flips"].size),
            "flips_near_faces": info["near"],
            "voxels_near_faces_share": float(every.mean()),
            "face_points": info["face_points"],
            "total_hits": info["hits"],
            "problems": problems,
        }
        cs.log(f"{name} {tag}: {json.dumps(rows[tag])}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=cs.FRAMES)
    ap.add_argument("--width", type=int, default=cs.WIDTH)
    ap.add_argument("--height", type=int, default=cs.HEIGHT)
    ap.add_argument("--scenes", default="bench,bench_far,flagship,"
                    "flagship_s1")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    import torch
    from hifi_fusion_tpu_torch.config import FusionConfig
    from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                       make_depth_sweep)
    cs.WIDTH, cs.HEIGHT = args.width, args.height
    fields = {**cs.BENCH_FIELDS, "max_points": args.width * args.height}
    card = cs.nvidia_smi() if args.device == "cuda" else "cpu"
    cs.log(f"oracle_flips: {card}")
    rays_np = camera_rays(args.width, args.height,
                          fx=cs.FX * args.width / cs.WIDTH,
                          fy=cs.FX * args.width / cs.WIDTH)
    bench = FusionConfig(**fields).validate()
    flag = FusionConfig(**{**fields, "bbox": cs.FLAGSHIP_BBOX})
    flag_sub = dataclasses.replace(flag, bbox=cs.FLAGSHIP_SUB_BBOX)
    far = dataclasses.replace(bench, bbox=BENCH_FAR_BBOX)
    plan = {"bench": (bench, bench, 0), "bench_far": (bench, far, 0),
            "flagship": (flag, flag_sub, 0),
            "flagship_s1": (flag, flag_sub, 1)}
    out = {"card": card, "frames": args.frames,
           "width": args.width, "height": args.height}
    sweeps = {}
    for name in args.scenes.split(","):
        sweep_cfg, grid_cfg, seed = plan[name]
        key = (sweep_cfg.bbox, seed)
        if key not in sweeps:
            sweeps[key] = make_depth_sweep(
                sweep_cfg, args.frames, width=args.width,
                height=args.height, seed=seed, noise_sd=3e-4,
                camera_height=0.4, srays=rays_np,
                arc_frames=args.frames * cs.ARC_FRAMES // cs.FRAMES)
        out[name] = {"bbox": grid_cfg.bbox, "seed": seed, **scene(
            torch, name, grid_cfg.validate(), sweeps[key], rays_np,
            args.device, card)}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

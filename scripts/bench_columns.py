#!/usr/bin/env python
"""Columns-axis scaling: the coupled step at O(1000) SP columns.

The reference's design point is "one LES per selected GCM column, up to
thousands" (SURVEY section 2.4 P1; /root/reference/splib/splib.py:554-593).
This harness runs the FULL driver — fused coupled step, diag pack, spifs
writer, timing.txt — over a growing fleet (default 64 -> 256 -> 1024
columns) and records per-step wall clock, host IO time, diag-bundle
size, spifs.nc size, and RSS. On the CPU test mesh use small LES grids
(correctness/orchestration evidence); on the real chip pick a grid that
fits HBM (throughput evidence).

Usage:
  python scripts/bench_columns.py [--sizes 64,256,1024] [--nx 16 --ny 16
      --nz 32] [--steps 3] [--trunc 63] [--mesh_les N] [--out OUT.md]
"""

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def pick_points(trunc, n):
    """n distinct GCM columns spread over the globe (|lat| < 60)."""
    from sp_coupler.models.gcm import spharm
    sht = spharm.SpectralTransform(trunc)
    lats = np.asarray(sht.latitudes_deg())
    lons = np.asarray(sht.longitudes_deg())
    rows = np.where(np.abs(lats) < 60.0)[0]
    # row-major strided selection: n distinct (row, col) pairs
    npairs = len(rows) * len(lons)
    if n > npairs:
        raise SystemExit("n=%d exceeds %d available columns" % (n, npairs))
    idx = (np.arange(n, dtype=np.int64) * npairs) // n
    pts = []
    for i in idx:
        r = rows[i // len(lons)]
        c = int(i % len(lons))
        pts.append((float(lons[c]), float(lats[r])))
    return pts


def run_size(args, n):
    import jax
    from sp_coupler.config import SPConfig
    from sp_coupler.runtime.driver import SPRunner
    from sp_coupler.utils import geometry

    odir = os.path.join(args.workdir, "cols_%04d" % n)
    cfg = SPConfig(
        output_dir=odir, gcm_type="sptpu", les_type="sptpu",
        gcm_truncation=args.trunc, gcm_levels=args.nlev,
        gcm_dt=args.gcm_dt,
        les_itot=args.nx, les_jtot=args.ny, les_ktot=args.nz,
        les_xsize=args.dx * args.nx, les_ysize=args.dx * args.ny,
        les_dz=args.dz, les_dt=args.les_dt,
        les_nsubsteps=args.nsubsteps,
        les_evolve_chunks=args.evolve_chunks,
        mesh_les=args.mesh_les, timing_phases=0,
        gcm_steps=args.steps)
    pts = [geometry.Point(p) for p in pick_points(args.trunc, n)]
    t0 = time.time()
    r = SPRunner(cfg, pts)
    r.initialize()
    n_cols = len(r.sp_cols)
    t_init = time.time() - t0
    t0 = time.time()
    r.run(1)                      # includes compile
    t_first = time.time() - t0
    t0 = time.time()
    r.run(args.steps - 1)
    t_rest = time.time() - t0
    r.finalize(save_restart=False)
    step_s = t_rest / max(args.steps - 1, 1)
    diag_bytes = 0
    if r.coupled is not None and getattr(r.coupled, "_diag_spec", None):
        _, shapes, _ = r.coupled._diag_spec
        diag_bytes = int(sum(int(np.prod(s)) if s else 1
                             for s in shapes)) * 4
    # host IO column (trailing) of timing.txt
    io_s = []
    with open(os.path.join(odir, "timing.txt")) as f:
        for ln in f:
            parts = ln.split()
            # data rows start with the fractional unix start time (the
            # sp-column index line after the header has bare integers)
            if (not ln.startswith("#") and len(parts) >= 7
                    and "." in parts[0]):
                io_s.append(float(parts[-1]))
    spifs_mb = os.path.getsize(os.path.join(odir, "spifs.nc")) / 1e6
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    updates = n_cols * args.nx * args.ny * args.nz
    row = {
        "n_cols": n_cols, "init_s": round(t_init, 1),
        "first_step_s": round(t_first, 1), "step_s": round(step_s, 2),
        "io_s_mean": round(float(np.mean(io_s)), 3) if io_s else None,
        "diag_pack_mb": round(diag_bytes / 1e6, 2),
        "spifs_mb": round(spifs_mb, 1), "rss_gb": round(rss_gb, 2),
        "gridpoints": updates,
    }
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="64,256,1024")
    ap.add_argument("--trunc", type=int, default=63)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--gcm_dt", type=float, default=900.0)
    ap.add_argument("--nx", type=int, default=16)
    ap.add_argument("--ny", type=int, default=16)
    ap.add_argument("--nz", type=int, default=32)
    ap.add_argument("--dx", type=float, default=200.0)
    ap.add_argument("--dz", type=float, default=100.0)
    ap.add_argument("--les_dt", type=float, default=-1.0)
    ap.add_argument("--nsubsteps", type=int, default=0)
    ap.add_argument("--evolve_chunks", type=int, default=1)
    ap.add_argument("--mesh_les", type=int, default=1)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--workdir", default="/tmp/bench_columns")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax
    backend = jax.default_backend()
    print("backend:", backend, " devices:", len(jax.devices()), flush=True)
    rows = []
    for n in [int(s) for s in args.sizes.split(",")]:
        rows.append(run_size(args, n))

    if args.out:
        with open(args.out, "w") as f:
            f.write("# Columns-axis scaling (%s, %d device(s))\n\n"
                    % (backend, len(jax.devices())))
            f.write("T%d/L%d GCM, %dx%dx%d LES per column, %d coupled "
                    "steps per size; full driver (fused step + diag "
                    "pack + spifs writer).\n\n" % (
                        args.trunc, args.nlev, args.nx, args.ny, args.nz,
                        args.steps))
            f.write("| columns | step (s) | host IO (s) | diag pack (MB)"
                    " | spifs.nc (MB) | RSS (GB) |\n|---|---|---|---|---|---|\n")
            for r in rows:
                f.write("| %d | %.2f | %.3f | %.2f | %.1f | %.2f |\n" % (
                    r["n_cols"], r["step_s"], r["io_s_mean"] or 0.0,
                    r["diag_pack_mb"], r["spifs_mb"], r["rss_gb"]))
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

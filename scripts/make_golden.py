#!/usr/bin/env python
"""Record the golden BASELINE config-2 run: T21 + 16 SP columns, 100 steps.

The reference regression mechanism replays a recorded spifs.nc through the
coupling layer and compares every value the coupler would have sent back
against the recording (/root/reference/splib/ncmod.py:167-170, 245-261).
This script produces that recording on the current backend;
tests/test_golden.py replays it.

Usage:  python scripts/make_golden.py [outdir] [steps]
Writes  <outdir>/spifs.nc + golden_meta.json  (default tests/golden).
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# 1-20N x 58-37.5W: exactly 16 T21 Gaussian columns (4 lats x 4 lons);
# polygon selection keeps every contained column (reference sputils.py:46-72
# ignores nmax for polygons), so the box itself defines the count
POLY = ["20", "-58", "1", "-58", "1", "-37.5", "20", "-37.5"]


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "tests", "golden")
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    cmd = [sys.executable, os.path.join(REPO, "spmaster.py"),
           "--steps", str(steps), "--poly", *POLY,
           "--numles", "16", "--gcmexp", "TEST",
           "--odir", outdir, "--cplsurf"]
    t0 = time.time()
    subprocess.run(cmd, check=True, cwd=REPO)
    wall = time.time() - t0
    import jax
    import numpy as np
    from sp_coupler.io import spifs
    # derive meta from the recording itself so it can never misdocument
    # the artifact (a hand-maintained meta drifted once already)
    ds = spifs.open_reader(os.path.join(outdir, "spifs.nc"))
    times = np.asarray(ds.variables["Time"][:])
    les_grid = [int(ds.variables[k].shape[0]) for k in ("x", "y", "zf")]
    columns = sorted(int(g) for g in ds.groups)
    ds.close()
    meta = {
        "case": "T21 + 16 SP columns (BASELINE config 2)",
        "steps": len(times) - 1,
        "gcm_dt_s": float(times[1] - times[0]),
        "les_grid": les_grid, "poly_lat_lon": POLY,
        "columns": columns,
        "platform": jax.devices()[0].platform,
        "device": str(jax.devices()[0]),
        "wall_s": round(wall, 1),
        "recorded_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    with open(os.path.join(outdir, "golden_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    for p in [os.path.join(outdir, "restart.npz"),
              os.path.join(outdir, "restart.json")]:
        if os.path.exists(p):
            os.remove(p)
    print("golden recorded:", meta)


if __name__ == "__main__":
    main()

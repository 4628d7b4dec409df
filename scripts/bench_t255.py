#!/usr/bin/env python
"""BASELINE config 4: T255 GCM + fleets of 128x128x160 LES instances.

The target is "T255 + 256 LES (128x128x160) domain-decomposed across one
host". This bench runs the same coupled program with a fleet of
full-size (128x128x160) instances on one device (default 32) and records
step time + updates/s; --report rewrites the measured section of
verify/T255_CONFIG4.md above its memory-fit analysis.

Usage: python scripts/bench_t255.py [--n 32] [--steps 2] [--report]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


REPORT = """# BASELINE config 4 — T255 + 256 x (128 x 128 x 160) on one 4-card host

## Measured ({device})

{measured}

"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32, help="LES instances")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--report", action="store_true",
                    help="write verify/T255_CONFIG4.md")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sp_coupler.models.gcm import model as gcm_model
    from sp_coupler.models.les import (grid as lgrid, state as lstate,
                                           step as lstep, diag as ldiag)
    from sp_coupler.coupling import convert
    from sp_coupler.coupling.coupler import CoupledStepFn

    n_les = args.n
    gcfg = gcm_model.GCMConfig(trunc=255, nlev=19, dt=900.0, hybrid=True,
                               advection="sl")
    core = gcm_model.GCMCore(gcfg)
    grid = lgrid.LESGrid(nx=128, ny=128, nz=160, dx=100.0, dy=100.0,
                         dz=25.0)
    phys = lstep.LESPhysics()
    print("backend:", jax.default_backend(), " T255 grid:", core.nlat,
          "x", core.nlon, " n_les:", n_les, flush=True)

    gcm_state = core.initial_state(seed=0)
    lats = np.asarray(core.sht.latitudes_deg())
    rows = np.where(np.abs(lats) < 15.0)[0]
    cols = []
    for r in rows[:: max(1, len(rows) // 16)]:
        for k in range(16):
            cols.append(r * core.nlon + (k * core.nlon) // 16)
    cols = np.asarray(cols[:n_les], np.int32)
    assert len(cols) == n_les

    @jax.jit
    def init_les(gstate):
        zf = grid.zf()
        prof0 = core.column_profiles(gstate, jnp.asarray(cols))
        conv0 = jax.vmap(lambda p: convert.convert_profiles(p, zf))(prof0)
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(42), i))(jnp.arange(n_les))
        return jax.vmap(
            lambda u, v, thl, qt, ps, k: lstate.init_state(
                grid, u, v, thl, qt, ps, k))(
            conv0.u, conv0.v, conv0.thl, conv0.qt, conv0.ps, keys)

    les_state = init_les(gcm_state)
    step_fn = CoupledStepFn(core, grid, phys, cols, dt_les=15.0,
                            n_substeps=0, evolve_chunks=args.chunks,
                            serial_evolve="serial")
    prof = jax.vmap(lambda s: ldiag.slab_profiles(grid, s))(les_state)
    rain = jnp.zeros(n_les)

    print("compiling ...", flush=True)
    t0 = time.time()
    out = step_fn(gcm_state, les_state, prof, rain, 0, first=True)
    gcm_state, les_state, prof, rain, d = jax.block_until_ready(out)
    print("warmup %.0fs" % (time.time() - t0), flush=True)

    total_sub = 0
    t0 = time.time()
    for s in range(1, args.steps + 1):
        out = step_fn(gcm_state, les_state, prof, rain, s, first=False)
        gcm_state, les_state, prof, rain, d = jax.block_until_ready(out)
        total_sub += int(np.sum(
            step_fn.unpack_diag(np.asarray(d))["n_substeps"]))
    el = time.time() - t0
    thl = np.asarray(prof["THL"])
    assert np.all(np.isfinite(thl))
    ups = grid.nx * grid.ny * grid.nz * total_sub / el
    step_s = el / args.steps
    line = {
        "bench": "t255_config4", "backend": jax.default_backend(),
        "n_les": n_les, "les_grid": [128, 128, 160],
        "step_s": round(step_s, 2), "substeps": total_sub,
        "les_updates_per_s": round(ups, 1),
    }
    print(json.dumps(line), flush=True)

    if args.report:
        measured = (
            "T255/L19 (hybrid, semi-Lagrangian) coupled to %d instances "
            "of 128x128x160 on one chip: **%.2f s/coupled-step** "
            "(%d adaptive substeps total, %.3e LES gridpoint-updates/s)."
            % (n_les, step_s, total_sub, ups))
        from sp_coupler.runtime import device
        outp = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "sp_coupler", "verify",
            "T255_CONFIG4.md")
        with open(outp) as f:
            fit = "## Memory fit" + f.read().split("## Memory fit", 1)[1]
        with open(outp, "w") as f:
            f.write(REPORT.format(device=device.nvidia_smi(),
                                  measured=measured) + fit)
        print("wrote", outp)
    return 0


if __name__ == "__main__":
    sys.exit(main())

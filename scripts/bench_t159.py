#!/usr/bin/env python
"""BASELINE north-star config: T159 regional SP + 64 batched LES columns
(64x64x160 each) on a single chip — full coupled steps, reports step
wall-clock and LES gridpoint-updates/s."""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def main(schedule="auto"):
    from sp_coupler.models.gcm import model as gcm_model
    from sp_coupler.models.les import (grid as lgrid, state as lstate,
                                           step as lstep, diag as ldiag)
    from sp_coupler.coupling import convert
    from sp_coupler.coupling.coupler import CoupledStepFn

    n_les = 64
    gcfg = gcm_model.GCMConfig(trunc=159, nlev=19, dt=900.0)
    core = gcm_model.GCMCore(gcfg)
    grid = lgrid.LESGrid()
    phys = lstep.LESPhysics()
    print("backend:", jax.default_backend(), " T159 grid:",
          core.nlat, "x", core.nlon, flush=True)

    gcm_state = core.initial_state(seed=0)
    # 64 columns in a tropical band (regional superparameterization)
    lats = np.asarray(core.sht.latitudes_deg())
    rows = np.where(np.abs(lats) < 15.0)[0]
    cols_2d = []
    for r in rows[:: max(1, len(rows) // 8)]:
        for k in range(8):
            cols_2d.append(r * core.nlon + (k * core.nlon) // 8)
    cols = np.asarray(cols_2d[:n_les], np.int32)
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
    # chunk the evolve: bounds one device execution to ~70 substeps
    # (some runtimes deadline multi-minute single programs)
    step_fn = CoupledStepFn(core, grid, phys, cols, dt_les=15.0,
                            n_substeps=0, evolve_chunks=8,
                            serial_evolve=schedule)
    print("schedule:", schedule, flush=True)
    prof = jax.vmap(lambda s: ldiag.slab_profiles(grid, s))(les_state)
    rain = jnp.zeros(n_les)

    print("compiling ...", flush=True)
    t0 = time.time()
    out = step_fn(gcm_state, les_state, prof, rain, 0, first=True)
    gcm_state, les_state, prof, rain, d = jax.block_until_ready(out)
    out = step_fn(gcm_state, les_state, prof, rain, 1, first=False)
    gcm_state, les_state, prof, rain, d = jax.block_until_ready(out)
    print("warmup %.0fs" % (time.time() - t0), flush=True)

    n_timed, total_sub = 2, 0
    t0 = time.time()
    for s in range(2, n_timed + 2):
        out = step_fn(gcm_state, les_state, prof, rain, s, first=False)
        gcm_state, les_state, prof, rain, d = jax.block_until_ready(out)
        total_sub += int(np.sum(
            step_fn.unpack_diag(np.asarray(d))["n_substeps"]))
    el = time.time() - t0
    thl = np.asarray(prof["THL"])
    assert np.all(np.isfinite(thl))
    ups = grid.nx * grid.ny * grid.nz * total_sub / el
    print("T159 + %d LES: %.2f s/coupled-step, %d substeps, %.3e "
          "LES updates/s/chip" % (n_les, el / n_timed, total_sub, ups),
          flush=True)
    print(json.dumps({
        "bench": "t159_64les", "schedule": schedule,
        "backend": jax.default_backend(),
        "step_s": round(el / n_timed, 2), "substeps": total_sub,
        "les_updates_per_s": ups}), flush=True)
    return 0


if __name__ == "__main__":
    sched = sys.argv[1] if len(sys.argv) > 1 else "auto"
    sys.exit(main(sched))

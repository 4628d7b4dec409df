#!/usr/bin/env python
"""Straggler decoupling: serial (lax.map) vs batched (vmap) fleet evolve.

Builds a HETEROGENEOUS fleet — instances with different wind speeds, so
CFL gives them different substep counts — and times evolve_adaptive under
both schedules for the same interval. The batched while_loop paces every
instance at the slowest one (device work = n * max_i substeps); the
serial schedule runs each instance's own loop (work = sum_i substeps).
Reference behavior: fully independent instances (splib.py:554-593).
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from sp_coupler.models.les import (grid as lgrid, state as lstate,
                                       step as lstep)
from sp_coupler.models.les.state import LESForcing

N_LES = 4
SPAN = 60.0


def main():
    grid = lgrid.LESGrid()
    phys = lstep.LESPhysics()
    print("backend:", jax.default_backend(), " n_les:", N_LES, flush=True)

    keys = jax.random.split(jax.random.PRNGKey(0), N_LES)
    zf = grid.zf()
    nz = grid.nz
    # wind 3 .. 24 m/s across the fleet: ~4x substep-count spread
    winds = jnp.linspace(3.0, 24.0, N_LES)
    st = jax.vmap(lambda k, u0: lstate.init_state(
        grid, jnp.full(nz, u0), jnp.full(nz, -3.0),
        298.0 + 6e-3 * zf, 16e-3 * jnp.exp(-zf / 2500.0),
        jnp.asarray(101500.0), k))(keys, winds)
    zero = jnp.zeros((N_LES, nz))
    zs = jnp.zeros(N_LES)
    forcing = LESForcing(f_u=zero, f_v=zero, f_thl=zero, f_qt=zero,
                        f_ql=zero, f_ps=zs, ql_ref=zero,
                        wthl=zs + 0.01, wqt=zs + 1e-5,
                        z0m=zs + 0.1, z0h=zs + 0.02)

    results = {}
    for serial in (False, True):
        one = lambda s, f: lstep.evolve_adaptive(
            grid, phys, s, f, s.time + SPAN, dt_max=15.0)
        fn = jax.jit(lambda s, f: lstep.map_fleet(one, s, f, serial))
        out = fn(st, forcing)
        np.asarray(out[1])  # compile + run
        reps = 3
        # perturb the input each rep (no result reuse), and time up to
        # the fetch of a tiny output
        sts = [st._replace(thl=st.thl + 1e-4 * (r + 1)) for r in range(reps)]
        for s_ in sts:
            jax.block_until_ready(s_)
        t0 = time.time()
        for r in range(reps):
            out = fn(sts[r], forcing)
            np.asarray(out[1])
        el = (time.time() - t0) / reps
        nsub = np.asarray(out[1])
        name = "serial" if serial else "batched"
        results[name] = el
        print("%-8s %8.3f s  substeps per instance %s (sum %d, max %d)"
              % (name, el, nsub, nsub.sum(), nsub.max()), flush=True)
    print("serial speedup on heterogeneous fleet: %.2fx"
          % (results["batched"] / results["serial"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

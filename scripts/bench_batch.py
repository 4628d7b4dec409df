#!/usr/bin/env python
"""LES fleet throughput vs batch size on one chip.

BASELINE.md targets T159 regional SP with ~64 batched LES columns per
chip; this measures gridpoint-updates/s for the 64x64x160 case at
n_les = 2..64 (fixed-dt scan of substeps, fused-stage kernel)."""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from sp_coupler.models.les import (grid as lgrid, state as lstate,
                                       step as lstep, poisson)
from sp_coupler.models.les.state import LESForcing

N_SUB = 20


def main():
    grid = lgrid.LESGrid()
    phys = lstep.LESPhysics()
    print("backend:", jax.default_backend(), flush=True)
    zf = grid.zf()
    nz = grid.nz
    pts = grid.nx * grid.ny * grid.nz

    for n in (2, 8, 16, 32, 64):
        keys = jax.random.split(jax.random.PRNGKey(0), n)
        st = jax.vmap(lambda k: lstate.init_state(
            grid, jnp.full(nz, 5.0), jnp.full(nz, -3.0),
            298.0 + 6e-3 * zf, 16e-3 * jnp.exp(-zf / 2500.0),
            jnp.asarray(101500.0), k))(keys)
        zero = jnp.zeros((n, nz))
        zs = jnp.zeros(n)
        forcing = LESForcing(f_u=zero, f_v=zero, f_thl=zero, f_qt=zero,
                             f_ql=zero, f_ps=zs, ql_ref=zero,
                             wthl=zs + 0.01, wqt=zs + 1e-5,
                             z0m=zs + 0.1, z0h=zs + 0.02)

        # the eigenbasis build (one eigh per instance) runs once per
        # COUPLED step (~560 substeps); hoist it so this harness doesn't
        # overweight it at N_SUB=20
        solver = jax.jit(jax.vmap(
            lambda s: poisson.build_solver(grid, s.rhobf, s.rhobh)))(st)

        @jax.jit
        def go(st, solver):
            def one(s, f, sol):
                def body(ss, _):
                    return lstep.substep(grid, phys, ss, f, 3.0,
                                         solver=sol)[0], ()
                return jax.lax.scan(body, s, None, length=N_SUB)[0]
            return jax.vmap(one)(st, forcing, solver)

        t0 = time.time()
        np.asarray(go(st, solver).thl[:, :1, :1, :1])
        compile_s = time.time() - t0
        t0 = time.time()
        reps = 2
        for _ in range(reps):
            np.asarray(go(st, solver).thl[:, :1, :1, :1])
        dtw = (time.time() - t0) / reps
        ups = n * pts * N_SUB / dtw
        print("n_les=%3d  %8.2f ms/substep-fleet  %10.3e updates/s  "
              "(compile %.0fs)" % (n, dtw / N_SUB * 1e3, ups, compile_s),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Measure evolve_adaptive per-substep cost at 128x128x160 (the T255
config-4 per-point-rate investigation): serial (lax.map) vs vmap fleet
pacing, plus a fixed-dt evolve for reference.
"""

import argparse
import time

import jax
import jax.numpy as jnp

from sp_coupler.models.les import grid as lgrid, state as lstate
from sp_coupler.models.les import step as lstep
from sp_coupler.models.les.state import LESForcing


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--span", type=float, default=112.5,
                    help="model seconds to advance (900/8 chunk)")
    args = ap.parse_args()
    n, nx = args.n, args.nx
    nz = 160
    grid = lgrid.LESGrid(nx=nx, ny=nx, nz=nz, dx=100.0, dy=100.0, dz=25.0)
    phys = lstep.LESPhysics()
    print("backend:", jax.default_backend(), "grid", nx, "n", n)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, n)
    zf = grid.zf()
    u0 = jnp.full(nz, 5.0)
    v0 = jnp.full(nz, -3.0)
    thl0 = 298.0 + 6e-3 * zf
    qt0 = 16e-3 * jnp.exp(-zf / 2500.0)
    st = jax.vmap(lambda k: lstate.init_state(
        grid, u0, v0, thl0, qt0, jnp.asarray(101500.0), k))(keys)
    zero = jnp.zeros((n, nz))
    zs = jnp.zeros(n)
    forcing = LESForcing(f_u=zero, f_v=zero, f_thl=zero, f_qt=zero,
                        f_ql=zero, f_ps=zs, ql_ref=zero,
                        wthl=zs + 0.01, wqt=zs + 1e-5,
                        z0m=zs + 0.1, z0h=zs + 0.02)
    npts = n * nz * nx * nx

    def one(s, f):
        return lstep.evolve_adaptive(grid, phys, s, f, s.time + args.span)

    # only the vmap fleet is timed here; bench_schedule.py compares
    # serial (lax.map) against batched pacing
    for name, serial in (("vmap", False),):
        fn = jax.jit(lambda st, f: lstep.map_fleet(one, st, f, serial))
        out = jax.block_until_ready(fn(st, forcing))
        t0 = time.time()
        out = jax.block_until_ready(fn(st, forcing))
        dt = time.time() - t0
        nsub = int(jnp.sum(out[1]))
        print("%-16s %7.1f ms total, %4d substeps, %6.2f ms/substep-inst,"
              " %.3e upd/s" % (name, dt * 1e3, nsub, dt * 1e3 / nsub,
                               nsub / n * npts / dt), flush=True)

    # fixed-dt evolve (no CFL reductions) for the floor
    nsteps = 24
    fn = jax.jit(lambda st, f: jax.vmap(
        lambda s, ff: lstep.evolve(grid, phys, s, ff, 3.0, nsteps))(st, f))
    out = jax.block_until_ready(fn(st, forcing))
    t0 = time.time()
    out = jax.block_until_ready(fn(st, forcing))
    dt = time.time() - t0
    print("fixed-dt evolve  %7.1f ms total, %4d substeps, %6.2f "
          "ms/substep-pair, %.3e upd/s"
          % (dt * 1e3, nsteps, dt * 1e3 / nsteps, npts * nsteps / dt),
          flush=True)


if __name__ == "__main__":
    main()

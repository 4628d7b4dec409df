#!/usr/bin/env python
"""Projection refine/precision trade: time (scan-amortized) and residual
for refine={0,1} x precision={HIGH,HIGHEST} on the bench case."""

import sys
import time

import jax
import jax.numpy as jnp

from sp_coupler.models.les import grid as lgrid, state as lstate, poisson
from sp_coupler.models.les.advect import divergence

N_LES = 2
NSCAN = 30


def main():
    grid = lgrid.LESGrid()
    print("backend:", jax.default_backend(), flush=True)
    keys = jax.random.split(jax.random.PRNGKey(0), N_LES)
    zf = grid.zf()
    nz = grid.nz
    st = jax.vmap(lambda k: lstate.init_state(
        grid, jnp.full(nz, 5.0) + 2e-3 * zf, jnp.full(nz, -3.0),
        298.0 + 6e-3 * zf, 16e-3 * jnp.exp(-zf / 2500.0),
        jnp.asarray(101500.0), k))(keys)
    dt = 3.0
    solver = jax.vmap(
        lambda s: poisson.build_solver(grid, s.rhobf, s.rhobh))(st)

    pre = float(jnp.max(jax.vmap(lambda s: jnp.max(jnp.abs(divergence(
        grid, s.rhobf, s.rhobh, s.u, s.v, s.w))))(st)))
    print("pre max|div|: %.3e" % pre, flush=True)

    for refine in (0, 1):
        for prec_name in ("HIGH", "HIGHEST"):
            prec = getattr(jax.lax.Precision, prec_name)
            orig = poisson._HI
            poisson._HI = prec
            try:
                def proj1(sb):
                    def one(s, sol):
                        div = divergence(grid, s.rhobf, s.rhobh,
                                         s.u, s.v, s.w) / dt
                        phi = poisson.solve_pressure(
                            grid, s.rhobf, s.rhobh, div, solver=sol,
                            refine=refine)
                        u = s.u - dt * (phi - jnp.roll(phi, 1, 2)) / grid.dx
                        v = s.v - dt * (phi - jnp.roll(phi, 1, 1)) / grid.dy
                        dpz = (phi[1:] - phi[:-1]) / grid.dz
                        z = jnp.zeros_like(s.w[:1])
                        w = s.w - dt * jnp.concatenate([z, dpz, z], 0)
                        return s._replace(u=u, v=v, w=w)
                    return jax.vmap(one)(sb, solver)

                def scanned(c):
                    def b(cc, _):
                        return proj1(cc), ()
                    return jax.lax.scan(b, c, None, length=NSCAN)[0]
                j = jax.jit(scanned)
                out = jax.block_until_ready(j(st))
                t0 = time.time()
                for _ in range(3):
                    out = jax.block_until_ready(j(st))
                per = (time.time() - t0) / 3 / NSCAN
                res = float(jnp.max(jax.vmap(
                    lambda s: jnp.max(jnp.abs(divergence(
                        grid, s.rhobf, s.rhobh, s.u, s.v, s.w))))(out)))
                # one-shot residual (not 30x chained)
                o1 = jax.block_until_ready(jax.jit(proj1)(st))
                res1 = float(jnp.max(jax.vmap(
                    lambda s: jnp.max(jnp.abs(divergence(
                        grid, s.rhobf, s.rhobh, s.u, s.v, s.w))))(o1)))
                print("refine=%d prec=%-7s  %7.3f ms  max|div| 1-shot "
                      "%.3e  30-chain %.3e" % (refine, prec_name, per * 1e3,
                                               res1, res), flush=True)
            finally:
                poisson._HI = orig
    return 0


if __name__ == "__main__":
    sys.exit(main())

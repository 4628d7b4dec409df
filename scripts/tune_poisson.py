#!/usr/bin/env python
"""Amortized micro-bench of the Poisson projection (T255 plane-efficiency
investigation): times poisson.project and solve_pressure in a chained
fori_loop (single dispatch) at 64x64 and 128x128 planes, n instances.
"""

import argparse
import time

import jax
import jax.numpy as jnp

from sp_coupler.models.les import grid as lgrid, poisson


def timeit(name, fn, arg, reps):
    f = jax.jit(fn)
    jax.block_until_ready(f(arg))
    t0 = time.time()
    jax.block_until_ready(f(arg))
    dt = (time.time() - t0) / reps
    print("%-34s %8.3f ms" % (name, dt * 1e3), flush=True)
    return dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nz", type=int, default=160)
    ap.add_argument("--n", type=int, default=2)
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args()
    print("backend:", jax.default_backend())
    for nx in (64, 128):
        grid = lgrid.LESGrid(nx=nx, ny=nx, nz=args.nz,
                             dx=200.0, dy=200.0, dz=25.0)
        zf = grid.zf()
        rhobf = jnp.exp(-zf / 8000.0)
        rhobh = jnp.exp(-grid.zh() / 8000.0)
        key = jax.random.PRNGKey(1)
        rhs = jax.random.normal(key, (args.n, args.nz, nx, nx))
        u = jax.random.normal(key, (args.n, args.nz, nx, nx))
        w = jax.random.normal(key, (args.n, args.nz + 1, nx, nx))
        solver = poisson.build_solver(grid, rhobf, rhobh)

        def chain_solve(r):
            def body(_, r):
                return jax.vmap(lambda q: poisson.solve_pressure(
                    grid, rhobf, rhobh, q, solver=solver, refine=0))(r)
            return jax.lax.fori_loop(0, args.reps, body, r)

        def chain_solve_r1(r):
            def body(_, r):
                return jax.vmap(lambda q: poisson.solve_pressure(
                    grid, rhobf, rhobh, q, solver=solver, refine=1))(r)
            return jax.lax.fori_loop(0, args.reps, body, r)

        def chain_project(uu):
            def body(_, uu):
                def one(q):
                    un, vn, wn, _ = poisson.project(
                        grid, rhobf, rhobh, q, u[0], w[0], 3.0,
                        solver=solver)
                    return un
                return jax.vmap(one)(uu)
            return jax.lax.fori_loop(0, args.reps, body, uu)

        npts = args.n * args.nz * nx * nx
        print("== %dx%dx%d x %d inst (%d pts)" % (nx, nx, args.nz,
                                                  args.n, npts))
        timeit("solve_pressure refine=0", chain_solve, rhs, args.reps)
        timeit("solve_pressure refine=1", chain_solve_r1, rhs, args.reps)
        timeit("project (full)", chain_project, u, args.reps)


if __name__ == "__main__":
    main()

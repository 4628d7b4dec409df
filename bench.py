#!/usr/bin/env python
"""Benchmark: the reference T21 + 2-LES case, one GPU.

Metric: LES grid-point updates per second per chip on the coupled
configuration of run_T21_sockets.sh — T21/L19 GCM (900 s steps) coupled to
2 LES instances of 64 x 64 x 160 (the dales-input RICO case).

Baseline (BASELINE.md): the reference does ~470 s per coupled step on a
quad-core i7-4790, with each DALES instance taking ~15 adaptive substeps
per 900 s GCM step => 2 * 64*64*160 * 15 / 470 s ~= 4.18e4 grid-point
updates/s. vs_baseline is measured throughput over that number.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", "phase_ms", ...}; "device" names JAX's platform, device kind and
count and the card's nvidia-smi name and power limit. Refuses to run
(non-zero exit) when JAX finds no GPU: a CPU number is not this metric.
"""

import json
import sys
import time

import numpy as np

REF_GRIDPOINTS_PER_S = 2 * 64 * 64 * 160 * 15 / 470.0  # ~41.8e3


def main():
    import jax
    import jax.numpy as jnp
    from sp_coupler.runtime import compile_cache, device
    try:
        dev = device.require_gpu()
    except RuntimeError as e:
        print("bench: %s" % e, file=sys.stderr)
        return 1
    compile_cache.configure()
    from sp_coupler.models.gcm import model as gcm_model
    from sp_coupler.models.les import (grid as lgrid, state as lstate,
                                           step as lstep, diag as ldiag)
    from sp_coupler.coupling.coupler import CoupledStepFn

    from sp_coupler.coupling import convert

    n_les = 2
    dt_les = 15.0   # max substep; actual dt is CFL-adaptive like DALES

    gcfg = gcm_model.GCMConfig(trunc=21, nlev=19, dt=900.0)
    core = gcm_model.GCMCore(gcfg)
    grid = lgrid.LESGrid()  # 64 x 64 x 160 reference case
    phys = lstep.LESPhysics()

    print("bench: initializing states ...", file=sys.stderr, flush=True)
    gcm_state = core.initial_state(seed=0)
    # the two Barbados-region columns of the reference case; LES instances
    # start from the GCM column state like the real driver (set_les_state)
    cols = np.asarray([1208, 1272], np.int32)

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

    step_fn = CoupledStepFn(core, grid, phys, cols, dt_les=dt_les,
                            n_substeps=0)
    prof = jax.vmap(lambda s: ldiag.slab_profiles(grid, s))(les_state)
    rain = jnp.zeros(n_les)

    # warmup: first=True and first=False compile to DIFFERENT programs
    # (static leapfrog Euler-start arg); run one step of each so the timed
    # window measures steady state, not a recompile
    print("bench: compiling + first coupled step ...", file=sys.stderr,
          flush=True)
    t0 = time.time()
    out = step_fn(gcm_state, les_state, prof, rain, 0, first=True)
    gcm_state, les_state, prof, rain, d0 = jax.block_until_ready(out)
    out = step_fn(gcm_state, les_state, prof, rain, 1, first=False)
    gcm_state, les_state, prof, rain, d0 = jax.block_until_ready(out)
    warm = time.time() - t0
    print("bench: warmup %.0fs, %s substeps" % (
        warm, np.asarray(step_fn.unpack_diag(np.asarray(d0))["n_substeps"])),
        file=sys.stderr, flush=True)

    n_timed = 3
    total_sub = 0
    t0 = time.time()
    for s in range(2, n_timed + 2):
        out = step_fn(gcm_state, les_state, prof, rain, s, first=False)
        gcm_state, les_state, prof, rain, diag = jax.block_until_ready(out)
        total_sub += int(np.sum(
            step_fn.unpack_diag(np.asarray(diag))["n_substeps"]))
    elapsed = time.time() - t0

    thl = np.asarray(prof["THL"])
    assert np.all(np.isfinite(thl)), "NaN in coupled state"

    phase = phase_breakdown(grid, phys, les_state)

    updates = grid.nx * grid.ny * grid.nz * total_sub
    gps = updates / elapsed
    print(json.dumps({
        "metric": "les_gridpoint_updates_per_s_per_device",
        "value": round(gps, 1),
        "unit": "gridpoint-updates/s (T21+2xLES 64x64x160 coupled, "
                "adaptive dt, %d total substeps; step %.2fs, warmup %.0fs)"
                % (total_sub, elapsed / n_timed, warm),
        "vs_baseline": round(gps / REF_GRIDPOINTS_PER_S, 2),
        "device": dev,
        **phase,
    }))
    return 0


def phase_breakdown(grid, phys, les_state):
    """Self-consistent substep phase accounting.

    All numbers come from the SAME scanned in-context program: the full
    substep is timed, then re-timed with the pressure projection skipped
    (substep(..., skip_projection=True)); the difference IS the in-context
    cost of the 3 projections and the remainder is the 3 RK stages +
    glue — so stage3 + projection3 == substep by construction, unlike
    standalone phase scans (whose per-phase carries add layout overhead
    the fused program doesn't pay).

    Also emits the bytes XLA's cost analysis counts for one substep
    without the projection (the 3 RK stages: its per-fusion operand and
    result bytes, i.e. its own estimate of HBM traffic) and the rate that
    traffic implies at the measured stage time.
    """
    import time as _time
    import jax
    import jax.numpy as jnp
    from sp_coupler.models.les import step as lstep, poisson
    from sp_coupler.models.les.state import LESForcing

    n = les_state.thl.shape[0]
    nz = grid.nz
    zero = jnp.zeros((n, nz))
    zs = jnp.zeros(n)
    forcing = LESForcing(f_u=zero, f_v=zero, f_thl=zero, f_qt=zero,
                         f_ql=zero, f_ps=zs, ql_ref=zero,
                         wthl=zs + 0.01, wqt=zs + 1e-5,
                         z0m=zs + 0.1, z0h=zs + 0.02)
    dt = 3.0
    solver = jax.vmap(
        lambda s: poisson.build_solver(grid, s.rhobf, s.rhobh))(les_state)

    def scan_time(body1, carry0, nscan=50, reps=3):
        def scanned(c):
            def b(cc, _):
                return body1(cc), ()
            return jax.lax.scan(b, c, None, length=nscan)[0]
        j = jax.jit(scanned)
        jax.block_until_ready(j(carry0))
        t0 = _time.time()
        for _ in range(reps):
            jax.block_until_ready(j(carry0))
        return (_time.time() - t0) / reps / nscan

    def sub1(skip):
        def f(sb):
            def one(s, f_, sol):
                return lstep.substep(grid, phys, s, f_, dt, solver=sol,
                                     skip_projection=skip)[0]
            return jax.vmap(one)(sb, forcing, solver)
        return f

    t_full = scan_time(sub1(False), les_state)
    t_noproj = scan_time(sub1(True), les_state)
    t_proj3 = max(t_full - t_noproj, 0.0)

    cost = jax.jit(sub1(True)).lower(les_state).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    stage_bytes = float(cost.get("bytes accessed", 0.0))
    out = {
        "phase_ms": {
            "substep": round(t_full * 1e3, 3),
            "stage_x3": round(t_noproj * 1e3, 3),
            "projection_x3": round(t_proj3 * 1e3, 3),
        },
        "phase_method": "in-context differential: same scanned program "
                        "with/without the projection; stage_x3 + "
                        "projection_x3 == substep by construction",
        "stage_x3_bytes": stage_bytes,
        "stage_x3_gbs": round(stage_bytes / 1e9 / max(t_noproj, 1e-12), 1),
    }
    return out


if __name__ == "__main__":
    sys.exit(main())

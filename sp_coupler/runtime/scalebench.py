"""Scaling-efficiency harness (BASELINE metric 3: N-host grid-points/s).

Runs the SAME per-device LES workload (per_dev instances of a fixed grid,
a fixed number of fixed-dt substeps) on growing sub-meshes of the
available devices and reports

    efficiency(m) = (updates/s on m devices / m) / (updates/s on 1 device)

— the weak-scaling metric of the BASELINE north star ("TL639 + thousands
of columns over >= 2 hosts at >= 80% grid-points/s scaling efficiency").
The fleet evolve is the same shard_map-over-`les` program the coupled
step uses (coupling/coupler.py:_evolve_to), so what is measured is the
production sharding, not a toy.

On the virtual CPU mesh (tests, MULTICHIP dry runs) the numbers are
STRUCTURAL: they bound the sharding/collective overhead XLA inserts, not
real interconnect bandwidth; on GPUs the same harness measures the real
thing. The reference has no equivalent — its scaling story is "add MPI
worker processes" (SURVEY.md P1/P2), never measured in-repo.
"""

import json
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..models.les import grid as lgrid, state as lstate, step as lstep
from ..models.les.state import LESForcing
from ..parallel import mesh as pmesh


def measure(sizes=None, per_dev=2, nx=32, ny=32, nz=64, substeps=12,
            reps=3, verbose=True, mode=None):
    """Scaling sweep; returns {"sizes", "updates_per_s", "efficiency"}.

    mode="weak" (accelerator default): per-device workload held fixed while the
    mesh grows; efficiency(m) = (ups_m / m) / ups_1 — the real metric on
    real chips.
    mode="fixed" (CPU default): TOTAL workload held fixed (per_dev *
    max(sizes) instances) while the mesh grows. Virtual CPU devices share
    the host's cores, so cross-size wall-clock comparisons are polluted by
    host-thread utilization (one virtual device does not saturate the
    cores, making m>1 look super-linear — VERDICT r3 weak #2). The
    baseline is therefore measured PER SIZE: the same total work on the
    SAME m devices as m independent per-device jitted programs dispatched
    concurrently (no shard_map, no partitioner, no collectives), so both
    sides use an identical core budget and
    efficiency(m) = t_ideal(m) / t_shard(m) <= ~1 by construction; any
    deficit is exactly the partitioning/collective overhead XLA inserts.
    """
    devs = jax.devices()
    n = len(devs)
    sizes = sizes or [s for s in (1, 2, 4, 8, 16, 32, 64, 128) if s <= n]
    if mode is None:
        mode = "fixed" if jax.default_backend() == "cpu" else "weak"
    grid = lgrid.LESGrid(nx=nx, ny=ny, nz=nz, dx=200.0, dy=200.0, dz=25.0)
    phys = lstep.LESPhysics()
    zf = np.asarray(grid.zf())
    thl = jnp.asarray(297.9 + np.maximum(zf - 740.0, 0) * 19.1 / 3260.0,
                      jnp.float32)
    qt = jnp.asarray(16e-3 * np.exp(-zf / 2500.0), jnp.float32)
    u0 = jnp.asarray(-9.9 + 2e-3 * zf, jnp.float32)
    v0 = jnp.full(nz, -3.8, jnp.float32)

    ups = {}
    ups_ideal = {}
    for m in sizes:
        mesh = pmesh.make_mesh(n_les=m, n_x=1, n_y=1, devices=devs[:m])
        n_les = per_dev * (max(sizes) if mode == "fixed" else m)
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(7), i))(jnp.arange(n_les))
        st = jax.vmap(lambda k: lstate.init_state(
            grid, u0, v0, thl, qt, 1.0e5, k))(keys)
        f0 = LESForcing.zeros(nz)._replace(
            wthl=jnp.asarray(0.01, jnp.float32),
            wqt=jnp.asarray(5e-5, jnp.float32),
            z0m=jnp.asarray(0.1, jnp.float32),
            z0h=jnp.asarray(0.02, jnp.float32))
        forcing = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (n_les,) + x.shape), f0)

        def evolve(s, f):
            return jax.vmap(lambda si, fi: lstep.evolve(
                grid, phys, si, fi, 2.0, substeps))(s, f)

        if mode == "fixed":
            # same-size ideal: the same total work as m independent
            # per-device programs (no partitioner, no collectives) on the
            # SAME m devices — identical core budget, so the ratio below
            # isolates sharding overhead rather than host utilization.
            per = n_les // m
            chunks = [
                jax.device_put(
                    jax.tree.map(lambda x, i=i: x[i * per:(i + 1) * per],
                                 (st, forcing)), devs[i])
                for i in range(m)
            ]
            ev1 = jax.jit(evolve)
            outs = [jax.block_until_ready(ev1(*c)) for c in chunks]

            def time_ideal():
                t0 = time.time()
                out = [ev1(*c) for c in chunks]       # async dispatch ...
                jax.block_until_ready(out)            # ... then one barrier
                return time.time() - t0
        else:
            time_ideal = None

        st = pmesh.shard_fleet(st, mesh)
        spec = jax.tree.map(
            lambda x: P("les") if getattr(x, "ndim", 0) >= 1 else P(),
            (st, forcing))
        ev = jax.jit(jax.shard_map(evolve, mesh=mesh, in_specs=spec,
                                   out_specs=spec[0]))
        st2 = jax.block_until_ready(ev(st, forcing))    # compile + warmup

        # INTERLEAVED min-over-repeats: the ideal and sharded legs are
        # timed back-to-back within each repeat so a host load spike (CI
        # runs on shared, busy hosts) hits both legs, and the min over
        # repeats drops the contaminated pairs — a sequentially-timed
        # ideal leg has been seen 1.8x slow purely from background load.
        el_min, el_ideal = None, None
        for _ in range(max(reps, 3) if time_ideal else reps):
            if time_ideal is not None:
                el = time_ideal()
                el_ideal = el if el_ideal is None else min(el_ideal, el)
            t0 = time.time()
            st2 = jax.block_until_ready(ev(st2, forcing))
            el = time.time() - t0
            el_min = el if el_min is None else min(el_min, el)
        if time_ideal is not None:
            ups_ideal[m] = n_les * nx * ny * nz * substeps / el_ideal
        ups[m] = n_les * nx * ny * nz * substeps / el_min
        if verbose:
            extra = ("  (ideal %.3e)" % ups_ideal[m]) if m in ups_ideal \
                else ""
            print("mesh les=%3d: %d instances, %.3e updates/s "
                  "(%.3e per device)%s"
                  % (m, n_les, ups[m], ups[m] / m, extra), flush=True)

    if mode == "weak":
        base = ups[sizes[0]] / sizes[0]
        eff = {m: (ups[m] / m) / base for m in sizes}
    else:
        # fixed total work, same-size ideal baseline: sharded vs
        # unpartitioned throughput on the SAME device count. The RAW
        # ratio is reported — a clamp would hide a mis-measured ideal
        # (slow ideal -> ratio > 1). On real accelerator meshes anything
        # beyond timing jitter above 1 means the baseline is wrong: fail
        # loudly. On the VIRTUAL-device CPU mesh the m independent ideal
        # programs contend for one shared host thread pool while the
        # single partitioned program schedules internally, so ratios up
        # to ~1.2 are a systematic property of the host, not a
        # mis-measurement — tolerated (and still reported raw).
        eff = {m: ups[m] / ups_ideal[m] for m in sizes}
        tol = 1.25 if jax.default_backend() == "cpu" else 1.05
        for m, e in eff.items():
            assert e <= tol, (
                "efficiency %.3f > %.2f at %d devices: the ideal "
                "(unpartitioned) baseline is mis-measured" % (e, tol, m))
    result = {
        "bench": "scaling_efficiency",
        "mode": mode,
        "backend": jax.default_backend(),
        "grid": [nx, ny, nz], "per_device_instances": per_dev,
        "substeps": substeps,
        "sizes": sizes,
        "updates_per_s": {str(m): round(ups[m], 1) for m in sizes},
        "efficiency": {str(m): round(eff[m], 4) for m in sizes},
    }
    if verbose:
        print(json.dumps(result), flush=True)
    return result

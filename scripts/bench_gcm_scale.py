#!/usr/bin/env python
"""GCM step-time table across truncations, up to TL639 (BASELINE config 5).

Times the full semi-implicit step (transforms + dycore + physics) and the
bare spectral round-trip per truncation on the current backend, printing a
table + one JSON line. The reference's TL639 capability claim comes from
OpenIFS namelists (/root/reference/oifs-input/fort.4 NPROC/TSTEP); here the
equivalent evidence is a measured chip step time at the same truncation.

Usage: python scripts/bench_gcm_scale.py [trunc ...]   (default 159 255 639)
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from sp_coupler.models.gcm import model as gm
from sp_coupler.models.gcm import spharm


def _roundtrip(core, x):
    return core.sht.synthesize(core.sht.analyze(x))

# OpenIFS-like level counts: coupling cases run L19/L60; TL639 production
# uses L91 — L60 keeps the memory of three time levels under control on
# one chip while exercising the same per-level transform batch
NLEV = {159: 60, 255: 60, 639: 60}
# dt per truncation: the semi-implicit treats gravity waves, but vertical
# advection and the physics coupling are explicit midpoint terms — with
# L60's thin stretch layers they are unstable beyond ~dt=1800 s
# regardless of truncation (measured: L60 blows up at dt=2700-3600 under
# BOTH advection schemes; stable at 720-1800). TL639 runs its production
# 720 s step; lower truncations use 1800 s.
DT = {159: 1800.0, 255: 1800.0, 639: 720.0}


def bench_trunc(trunc, repeats=10):
    nlev = NLEV.get(trunc, 60)
    # semi-Lagrangian: at these truncations the OpenIFS-like DT table
    # (3600/2700/720 s) is far beyond the Eulerian advective CFL
    cfg = gm.GCMConfig(trunc=trunc, nlev=nlev, dt=DT.get(trunc, 900.0),
                       hybrid=True, advection="sl")
    core = gm.GCMCore(cfg)
    state = core.initial_state(seed=1)

    # no outer jit: the phases are jitted internally with the spectral
    # tables threaded as arguments (TL639 tables as closure constants
    # break the remote compile)
    step = core.step
    state = step(state)  # compile + Euler start
    jax.block_until_ready(state)
    t0 = time.time()
    for _ in range(repeats):
        state = step(state)
    jax.block_until_ready(state)
    step_ms = (time.time() - t0) / repeats * 1e3
    assert bool(jnp.isfinite(state.now.vort).all()), "non-finite state"

    # bare spectral round-trip at the same batch size (nlev fields)
    sht = core.sht
    g = jnp.zeros((nlev, sht.nlat, sht.nlon), jnp.float32) + 1.0

    roundtrip = lambda x: core.apply(_roundtrip, x)

    r = roundtrip(g)
    jax.block_until_ready(r)
    t0 = time.time()
    for _ in range(repeats):
        r = roundtrip(r)
    jax.block_until_ready(r)
    rt_ms = (time.time() - t0) / repeats * 1e3
    return {"trunc": trunc, "nlev": nlev, "grid": [sht.nlat, sht.nlon],
            "dt_s": cfg.dt, "step_ms": round(step_ms, 2),
            "spectral_roundtrip_ms": round(rt_ms, 2)}


def main():
    truncs = [int(t) for t in sys.argv[1:]] or [159, 255, 639]
    rows = []
    for t in truncs:
        r = bench_trunc(t)
        rows.append(r)
        print("T%-4d L%d %4dx%-4d  step %8.2f ms   sht-roundtrip %8.2f ms"
              % (r["trunc"], r["nlev"], r["grid"][0], r["grid"][1],
                 r["step_ms"], r["spectral_roundtrip_ms"]))
    print(json.dumps({"backend": jax.default_backend(), "rows": rows}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""AOT memory analysis of the TL639 split-phase programs (no execution).

Lowers each split program with abstract (ShapeDtypeStruct) arguments at
first=False shapes and prints the compiler's memory analysis — argument,
output, and HLO-temp sizes — so OOMs can be attributed without burning
chip time. Uses the persistent compile cache.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from sp_coupler.models.gcm import model as gm, dycore

    trunc = int(sys.argv[1]) if len(sys.argv) > 1 else 639
    nlev = int(sys.argv[2]) if len(sys.argv) > 2 else 60
    only = sys.argv[3] if len(sys.argv) > 3 else ""
    kc_override = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    cfg = gm.GCMConfig(trunc=trunc, nlev=nlev, dt=720.0, hybrid=True,
                       advection="sl", split_phases=True)
    core = gm.GCMCore(cfg)
    if kc_override:
        core.slg.k_chunk = kc_override
    L, nlat, nlon = nlev, core.nlat, core.nlon
    M, N = core.sht.M, core.sht.N
    f32 = jnp.float32
    S = lambda *sh: jax.ShapeDtypeStruct(sh, f32)
    z = dycore.SpectralState.zeros(L, M, N)
    spec = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        z)
    cst = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                       core.consts())
    ang = S(L, nlat, nlon)
    ang2 = S(1, nlat, nlon)
    kc = core.slg.k_chunk
    nb = L // kc
    dep_blocked = S(nb, 8, kc, nlat, nlon)

    def report(name, jitfn, *args):
        if only and only not in name:
            return
        try:
            comp = jitfn.lower(*args).compile()
            ma = comp.memory_analysis()
            print("%-14s args %6.2f GB  out %6.2f GB  temp %6.2f GB  "
                  "total %6.2f GB" % (
                      name, ma.argument_size_in_bytes / 1e9,
                      ma.output_size_in_bytes / 1e9,
                      ma.temp_size_in_bytes / 1e9,
                      (ma.argument_size_in_bytes + ma.output_size_in_bytes
                       + ma.temp_size_in_bytes) / 1e9), flush=True)
        except Exception as e:
            print("%-14s FAILED: %s" % (name, str(e)[:200]), flush=True)

    report("sl_traj", core._sl_traj_jit, cst, spec, False)
    report("sl_dep_stack", core._sl_stack_jit, cst, spec, spec, False)
    report("sl_interp_dep", core._sl_dep_jit, cst,
           S(8, L, nlat, nlon), ang2, ang, ang, ang2, ang2)
    report("sl_prep_mid", core._sl_prep_mid_jit, cst, spec, False)
    report("sl_arrivals", core._sl_arr_jit, cst, S(8, L, nlat, nlon),
           ang2, ang, ang, ang2, ang2, dep_blocked, S(1, 1, nlat, nlon),
           False)
    arrs = [S(L, nlat, nlon)] * 7 + [S(nlat, nlon)]
    report("sl_solve", core._sl_solve_jit, cst, *arrs, False)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Probe the split-phase SL pipeline one device program at a time.

To find which program of phase A fails or dominates at TL639, this
script mirrors GCMCore.phase_a's split-mode sequence (model.py:281-307)
with a hard sync + wall timing after EVERY program so the failing
program and its cost are identified. Usage:
    python scripts/tl639_probe.py [--trunc 639] [--nlev 60] [--steps 2]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trunc", type=int, default=639)
    ap.add_argument("--nlev", type=int, default=60)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--dt", type=float, default=720.0)
    args = ap.parse_args()

    import jax
    from sp_coupler.models.gcm import model as gm

    cfg = gm.GCMConfig(trunc=args.trunc, nlev=args.nlev, dt=args.dt,
                       hybrid=True, advection="sl", split_phases=True)
    t0 = time.time()
    core = gm.GCMCore(cfg)
    print("init %.1fs  backend=%s grid %dx%d L%d  lon_bands=%s S_lat=%d"
          % (time.time() - t0, jax.default_backend(), core.nlat, core.nlon,
             args.nlev, core.slg.lon_bands, core.slg.S_lat), flush=True)

    t0 = time.time()
    state = core.initial_state(seed=1)
    core._tight_sync(state.now.vort)
    print("initial_state %.1fs" % (time.time() - t0), flush=True)
    state = state._replace(grid=None, sfc=None)

    def timed(name, fn, *a, **kw):
        t0 = time.time()
        out = fn(*a, **kw)
        core._tight_sync(jax.tree_util.tree_leaves(out)[0])
        print("  %-14s %.2fs" % (name, time.time() - t0), flush=True)
        return out

    cst = core.consts()
    first = True
    for i in range(args.steps):
        print("step %d:" % i, flush=True)
        mg = timed("sl_mid_grid", core._sl_mid_grid_jit, cst, state.now)
        mid = timed("sl_mid_terms", core._sl_mid_terms_jit, cst,
                    state.now, mg)
        del mg
        traj = timed("sl_traj", core._sl_traj_jit, cst, state.now, first)
        stack = timed("sl_dep_stack", core._sl_stack_jit, cst, state.now,
                      state.prev, first)
        angm = traj["angm"]
        dep_vals, pi_dep = timed("sl_interp_dep", core._sl_dep_jit, cst,
                                 stack["dep"], stack["pi_comb"],
                                 *traj["angd"])
        del stack, traj
        arr = timed("sl_arrivals", core._sl_arr_jit, cst, mid["mid"],
                    mid["N_pi"], *angm, dep_vals, pi_dep, first)
        del mid, angm, dep_vals, pi_dep
        new = timed("sl_solve", core._sl_solve_jit, cst, *arr, first)
        del arr
        state2 = timed("phase_a_phys", core._phase_a_phys_jit, cst, state,
                       new)
        state2 = timed("phase_cloud", core._phase_cloud_jit, state2)
        state = timed("phase_b", core._phase_b_jit, cst, state2, first)
        state = state._replace(grid=None, sfc=None)
        first = False
    u0 = float(np.asarray(state.now.vort[0, 0, 0, 0]))
    print("done; vort[0000]=%r" % u0, flush=True)


if __name__ == "__main__":
    sys.exit(main())

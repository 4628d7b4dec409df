#!/usr/bin/env python
"""Held-Suarez instability bisection harness.

Runs the canonical dry HS94 T42/L19 configuration (scripts/held_suarez.py)
under a chosen (advection, vertical-coordinate) combination, checking
finiteness and field extrema EVERY model day and reporting the first bad
day plus the vertical/latitudinal location of the first non-finite value.

Usage:
  python scripts/hs_bisect.py --advection sl  --hybrid 1 --days 150
  python scripts/hs_bisect.py --advection eul --hybrid 1 --days 150
  python scripts/hs_bisect.py --advection sl  --hybrid 0 --days 150
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--advection", default="sl")
    ap.add_argument("--hybrid", type=int, default=1)
    ap.add_argument("--days", type=int, default=150)
    ap.add_argument("--trunc", type=int, default=42)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sp_coupler.models.gcm import model as gm, physics

    phys = physics.PhysicsParams(dtheta_z=10.0, tau_rad=40.0 * 86400.0,
                                 tau_rad_sfc=4.0 * 86400.0,
                                 rayleigh_tau=86400.0)
    cfg = gm.GCMConfig(trunc=args.trunc, nlev=args.nlev, dt=args.dt,
                       hybrid=bool(args.hybrid), advection=args.advection,
                       phys=phys)
    core = gm.GCMCore(cfg)
    state = core.initial_state(seed=args.seed)
    state = state._replace(vdiff_mask=jnp.zeros_like(state.vdiff_mask))
    dry = state.now._replace(q=jnp.zeros_like(state.now.q),
                             ql=jnp.zeros_like(state.now.ql),
                             qi=jnp.zeros_like(state.now.qi),
                             a=jnp.zeros_like(state.now.a))
    state = state._replace(now=dry, prev=dry, new=dry)
    state = core.step(state, first=True)

    spd = int(round(86400.0 / args.dt))

    @jax.jit
    def day(s):
        def body(s, _):
            return core.step(s), None
        s, _ = jax.lax.scan(body, s, None, length=spd)
        return s

    t0 = time.time()
    prev_np = None
    for d in range(args.days):
        state = day(state)
        g = state.grid
        u = np.asarray(g.u)
        T = np.asarray(g.T)
        lnps = np.asarray(g.lnps)
        fin = np.isfinite(u).all() and np.isfinite(T).all() \
            and np.isfinite(lnps).all()
        row = {"day": d + 1,
               "umax": round(float(np.nanmax(np.abs(u))), 1),
               "Tmin": round(float(np.nanmin(T)), 1),
               "Tmax": round(float(np.nanmax(T)), 1),
               "ps_min": round(float(1e5 * np.exp(np.nanmin(lnps))) / 100, 1),
               "ps_max": round(float(1e5 * np.exp(np.nanmax(lnps))) / 100, 1),
               "finite": bool(fin)}
        print(json.dumps(row), flush=True)
        if not fin:
            # locate the first non-finite entries
            bad = ~np.isfinite(u)
            if bad.any():
                lev, lat, lon = np.unravel_index(np.argmax(bad), bad.shape)
                mu = np.asarray(core.sht.mu)
                print("first bad u at level %d/%d, lat %.1f deg, lon idx %d"
                      % (lev, args.nlev,
                         float(np.degrees(np.arcsin(mu[lat]))), lon),
                      flush=True)
            badT = ~np.isfinite(T)
            if badT.any():
                lev, lat, lon = np.unravel_index(np.argmax(badT), badT.shape)
                mu = np.asarray(core.sht.mu)
                print("first bad T at level %d/%d, lat %.1f deg"
                      % (lev, args.nlev,
                         float(np.degrees(np.arcsin(mu[lat])))), flush=True)
            if prev_np is not None:
                pu, pT = prev_np
                print("previous day: umax %.1f Tmin %.1f Tmax %.1f"
                      % (np.abs(pu).max(), pT.min(), pT.max()), flush=True)
            break
        prev_np = (u, T)
    print("wall %.1f s" % (time.time() - t0), flush=True)


if __name__ == "__main__":
    main()

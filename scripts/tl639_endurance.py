#!/usr/bin/env python
"""TL639 endurance run: >= 500 semi-Lagrangian steps at dt = 720 s with
strong jets — the BASELINE config-5 stability evidence.

The Eulerian dycore cannot run this: at TL639 (dx ~= 31 km at the
equator) a 60 m/s jet has an advective CFL of ~2.8 over the leapfrog
window at dt = 720 s. This script injects +-60 m/s midlatitude jets into
the TL639/L60 initial state (a deliberately harsh, UNBALANCED insult on
top of the HS94-style physics), runs the semi-Lagrangian model for
--steps steps, and records the wind/temperature trajectory. PASS = state
finite throughout, jets stay physical (10-150 m/s), no runaway.

Writes verify/TL639.md. Usage: python scripts/tl639_endurance.py
[--steps 600] [--trunc 639] [--nlev 60]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def _jet_zeta(core, jet_amp):
    """Relative vorticity of the +-jet_amp m/s midlatitude jets, host-
    side ([L, nlat] float64 on the exact Gaussian latitudes).

    The previous version synthesized the full state to grid, added the
    jet to u and re-analyzed vort/div — a ~10-transform fused program
    whose execution crashed the TL639 worker. The jet is zonal and
    analytic, so only its own vorticity  zeta = -(1/(a cos)) d(u cos)/
    dphi  needs adding to the spectral vorticity: one analyze call.
    """
    a = float(core.sht.radius)
    phi = np.arcsin(np.asarray(core.sht.mu, np.float64))   # [nlat]
    sig = np.asarray(core.vc.sf, np.float64)               # [L]
    ujet = (jet_amp
            * np.exp(-((np.abs(phi)[None, :] - np.radians(45.0))
                       / np.radians(15.0)) ** 2)
            * np.exp(-((sig[:, None] - 0.25) / 0.25) ** 2))  # [L, nlat]
    uc = ujet * np.cos(phi)[None, :]
    duc = np.gradient(uc, phi, axis=1)
    return -duc / (a * np.cos(phi)[None, :])


def _inject(core, s, zeta):
    """Add the jet vorticity (zeta: [L, nlat, 1] broadcastable grid
    field) to the spectral state; alias all three spectral slots."""
    import jax.numpy as jnp
    zeta_g = jnp.broadcast_to(zeta, (core.cfg.nlev, core.nlat,
                                     core.nlon))
    vort = s.now.vort + core.sht.analyze(zeta_g).astype(s.now.vort.dtype)
    now = s.now._replace(vort=vort * core.sht.mask[..., None])
    # alias new as well: keeping the PRE-inject spectral set alive in
    # s.new is +1.6 GB at TL639/L60 — enough to crash the first step
    return s._replace(now=now, prev=now, new=now)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--trunc", type=int, default=639)
    ap.add_argument("--nlev", type=int, default=60)
    ap.add_argument("--dt", type=float, default=720.0)
    ap.add_argument("--jet", type=float, default=60.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sp_coupler.models.gcm import model as gm

    cfg = gm.GCMConfig(trunc=args.trunc, nlev=args.nlev, dt=args.dt,
                       hybrid=True, advection="sl",
                       split_phases=args.trunc >= 400)
    core = gm.GCMCore(cfg)
    print("backend:", jax.default_backend(), " grid:", core.nlat, "x",
          core.nlon, " L", args.nlev, " dt", args.dt, flush=True)
    dx_eq = 2 * np.pi * 6.371e6 / core.nlon
    print("dx(equator) = %.1f km; CFL of a %.0f m/s jet over 2 dt = %.2f"
          % (dx_eq / 1e3, args.jet, args.jet * 2 * args.dt / dx_eq),
        flush=True)

    state = core.initial_state(seed=1)
    # core.apply / the internally-jitted phases thread the ~0.5 GB TL639
    # spectral tables as jit ARGUMENTS — an outer jax.jit here would
    # capture them as module constants and break the remote compile
    zeta = jnp.asarray(_jet_zeta(core, args.jet), jnp.float32)[..., None]
    state = core.apply(_inject, state, zeta, donate_first=True)
    np.asarray(state.now.vort[0, 0, 0, 0])   # force inject completion

    def strip(s):
        # Drop the previous step's grid view + surface fields before the
        # dynamics program launches: phase A's physics half rebuilds
        # both, and the dead buffers are ~1.5 GB of the 16 GB HBM at
        # TL639/L60. Must REBIND the loop variable before calling step —
        # `step(strip(state))` would keep the old pytree (and its grid)
        # alive through the outer binding for the whole call.
        return s._replace(grid=None, sfc=None)

    state = strip(state)
    stepn = core.step

    hist = []
    t0 = time.time()
    bad_at = None
    crash = None
    cad = min(50, max(args.steps // 5, 1))
    try:
        state = core.step(state, first=True)
        for i in range(args.steps):
            state = strip(state)
            state = stepn(state)
            if (i + 1) % 8 == 0:
                # tiny fetch: bounds the async dispatch queue
                np.asarray(state.now.vort[0, 0, 0, 0])
            if (i + 1) % cad == 0 or i + 1 == args.steps:
                u = np.asarray(state.grid.u)
                T = np.asarray(state.grid.T)
                finite = bool(np.all(np.isfinite(u))
                              and np.all(np.isfinite(T)))
                row = {"step": i + 1,
                       "umax": round(float(np.abs(u).max()), 1),
                       "Tmin": round(float(T.min()), 1),
                       "Tmax": round(float(T.max()), 1), "finite": finite}
                hist.append(row)
                print(row, flush=True)
                if not finite:
                    bad_at = i + 1
                    break
    except Exception as e:  # write an honest partial artifact on a crash
        import traceback
        traceback.print_exc()
        crash = "%s: %s" % (type(e).__name__, str(e)[:300])
        bad_at = (len(hist) * cad) or 1
        print("CRASH at ~step %d: %s" % (bad_at, crash), flush=True)
        if not hist:
            hist = [{"step": 0, "umax": float("nan"),
                     "Tmin": float("nan"), "Tmax": float("nan"),
                     "finite": False}]
    wall = time.time() - t0
    step_s = wall / (bad_at or args.steps)
    umax_final = hist[-1]["umax"]
    ok = (bad_at is None and crash is None
          and 10.0 <= umax_final <= 150.0
          and 150.0 < hist[-1]["Tmin"] and hist[-1]["Tmax"] < 340.0)
    line = {"bench": "tl639_endurance", "backend": jax.default_backend(),
            "trunc": args.trunc, "nlev": args.nlev, "dt_s": args.dt,
            "steps": bad_at or args.steps, "step_s": round(step_s, 3),
            "cfl_2dt": round(args.jet * 2 * args.dt / dx_eq, 2),
            "ok": ok}
    print(json.dumps(line), flush=True)

    out = args.out or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "sp_coupler", "verify", "TL639.md")
    with open(out, "w") as f:
        f.write("# TL639 semi-Lagrangian endurance run\n\n")
        f.write("T%d/L%d, dt=%.0f s, backend=%s, grid %dx%d "
                "(dx(eq)=%.1f km).\n\n" % (
                    args.trunc, args.nlev, args.dt, jax.default_backend(),
                    core.nlat, core.nlon, dx_eq / 1e3))
        f.write("Injected +-%.0f m/s midlatitude jets (advective CFL "
                "%.2f over the 2 dt window — impossible for the Eulerian "
                "leapfrog path, models/gcm/dycore.py). %d steps at %.3f "
                "s/step (%.0f s wall).\n\n" % (
                    args.jet, line["cfl_2dt"], line["steps"], step_s,
                    wall))
        f.write("| step | max|u| (m/s) | Tmin (K) | Tmax (K) | finite |\n")
        f.write("|---|---|---|---|---|\n")
        for r in hist:
            f.write("| %d | %.1f | %.1f | %.1f | %s |\n" % (
                r["step"], r["umax"], r["Tmin"], r["Tmax"], r["finite"]))
        if crash:
            f.write("\nRun aborted at ~step %d: `%s`\n" % (bad_at, crash))
        f.write("\n**Verdict: %s**\n" % ("PASS" if ok else "FAIL"))
    print("wrote", out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

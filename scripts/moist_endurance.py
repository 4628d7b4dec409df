#!/usr/bin/env python
"""Moist production-physics endurance run (VERDICT r4 missing #3).

The HS94 artifact validates the DYCORE under the published dry forcing;
production coupled runs use the default moist tropical-marine
PhysicsParams (Sundqvist cloud scheme, K-diffusion PBL, bulk surface
fluxes — models/gcm/physics.py). This runs that configuration, SP
columns absent, for --days model days at T42/L19 and gates on long-run
boundedness: state finite throughout, surface pressure, temperature and
moisture inside physical bounds, time-mean jets sane. The reference GCM
is production-stable over its 1000-step deck with full physics
(/root/reference/oifs-input/fort.4:26); this is the equivalent evidence
for the native GCM.

Writes verify/MOIST_T42.md. Usage:
  python scripts/moist_endurance.py [--days 100] [--trunc 42] [--dt 1800]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GATES = {
    "u_max_ms": 150.0,
    "T_K": (150.0, 340.0),
    "ps_hpa": (800.0, 1100.0),
    "q_max": 0.05,
    "jet_ms": (5.0, 60.0),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--days", type=int, default=100)
    ap.add_argument("--trunc", type=int, default=42)
    ap.add_argument("--nlev", type=int, default=19)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from sp_coupler.models.gcm import model as gm

    # DEFAULT physics: the moist setup every coupled run uses
    cfg = gm.GCMConfig(trunc=args.trunc, nlev=args.nlev, dt=args.dt,
                       hybrid=True, advection="sl")
    core = gm.GCMCore(cfg)
    print("backend:", jax.default_backend(), " T%d/L%d dt=%.0f moist "
          "default physics" % (args.trunc, args.nlev, args.dt), flush=True)
    state = core.initial_state(seed=args.seed)
    state = core.step(state, first=True)

    steps_per_day = int(round(86400.0 / args.dt))
    CHUNK = args.chunk or steps_per_day

    @jax.jit
    def chunk_fn(state):
        """One chunk of steps + on-device extrema/zonal-mean stats."""
        def body(carry, _):
            s, acc_u, cnt = carry
            s = core.step(s)
            return (s, acc_u + s.grid.u.mean(axis=2), cnt + 1), None

        zu = jnp.zeros((core.cfg.nlev, core.nlat))
        (s, au, c), _ = jax.lax.scan(
            body, (state, zu, jnp.zeros(())), None, length=CHUNK)
        g = s.grid
        from sp_coupler import constants as cns
        ps = cns.pref0 * jnp.exp(g.lnps)
        stats = jnp.stack([
            jnp.abs(g.u).max(), g.T.min(), g.T.max(), g.q.max(),
            ps.min(), ps.max()])
        return s, au, c, stats

    def sync(x):
        np.asarray(x[(0,) * x.ndim])

    acc_u = np.zeros((args.nlev, core.nlat))
    cnt = 0.0
    hist = []
    bad_at = None
    t0 = time.time()
    n_chunks = args.days * steps_per_day // CHUNK
    for i in range(n_chunks):
        state, au, c, stats = chunk_fn(state)
        stats = np.asarray(stats)
        day = (i + 1) * CHUNK / steps_per_day
        finite = bool(np.all(np.isfinite(stats)))
        row = {"day": round(day, 1),
               "umax": round(float(stats[0]), 1),
               "Tmin": round(float(stats[1]), 1),
               "Tmax": round(float(stats[2]), 1),
               "qmax": round(float(stats[3]), 5),
               "ps_min_hpa": round(float(stats[4]) / 100.0, 1),
               "ps_max_hpa": round(float(stats[5]) / 100.0, 1),
               "finite": finite}
        if (i + 1) % 5 == 0 or not finite or i + 1 == n_chunks:
            print(row, flush=True)
        hist.append(row)
        if not finite:
            bad_at = day
            break
        # second half contributes to the time-mean jet statistics
        if i >= n_chunks // 2:
            acc_u += np.asarray(au)
            cnt += float(c)
    wall = time.time() - t0

    ubar = acc_u / max(cnt, 1.0)
    lat = np.degrees(np.arcsin(np.asarray(core.sht.mu)))
    sig = np.asarray(core.vc.sf)
    upper = (sig > 0.15) & (sig < 0.45)
    jet_nh = float(ubar[np.ix_(upper, lat > 10)].max())
    jet_sh = float(ubar[np.ix_(upper, lat < -10)].max())

    last = hist[-1]
    tlo, thi = GATES["T_K"]
    plo, phi_g = GATES["ps_hpa"]
    jlo, jhi = GATES["jet_ms"]
    ok = (bad_at is None
          and all(h["umax"] <= GATES["u_max_ms"] for h in hist)
          and all(tlo <= h["Tmin"] and h["Tmax"] <= thi for h in hist)
          and all(plo <= h["ps_min_hpa"] and h["ps_max_hpa"] <= phi_g
                  for h in hist)
          and all(h["qmax"] <= GATES["q_max"] for h in hist)
          and jlo <= jet_nh <= jhi and jlo <= jet_sh <= jhi)
    line = {"bench": "moist_endurance", "backend": jax.default_backend(),
            "trunc": args.trunc, "nlev": args.nlev, "dt_s": args.dt,
            "days": bad_at or args.days, "wall_s": round(wall, 1),
            "jet_nh_ms": round(jet_nh, 1), "jet_sh_ms": round(jet_sh, 1),
            "ok": ok}
    print(json.dumps(line), flush=True)

    out = args.out or os.path.join(REPO, "sp_coupler", "verify",
                                   "MOIST_T42.md")
    with open(out, "w") as f:
        f.write("# Moist production-physics endurance (default "
                "PhysicsParams)\n\n")
        f.write("T%d/L%d, dt=%.0f s, %d days, backend=%s, %.0f s wall. "
                "Default moist tropical-marine physics (Sundqvist cloud "
                "scheme, K-diffusion PBL, bulk surface fluxes) — the "
                "configuration production coupled runs use, which the "
                "dry HS94 artifact does not cover.\n\n" % (
                    args.trunc, args.nlev, args.dt, line["days"],
                    line["backend"], wall))
        f.write("Time-mean upper-level jets (second half): NH %.1f m/s, "
                "SH %.1f m/s (moist subtropical jets; gate %.0f-%.0f "
                "m/s).\n\n" % (jet_nh, jet_sh, jlo, jhi))
        f.write("| day | max|u| | Tmin | Tmax | qmax | ps min (hPa) | "
                "ps max (hPa) | finite |\n|---|---|---|---|---|---|---|---|\n")
        step = max(len(hist) // 25, 1)
        shown = hist[::step]
        if hist[-1] is not shown[-1]:
            shown.append(hist[-1])
        for h in shown:
            f.write("| %.1f | %.1f | %.1f | %.1f | %.5f | %.1f | %.1f | "
                    "%s |\n" % (h["day"], h["umax"], h["Tmin"], h["Tmax"],
                                h["qmax"], h["ps_min_hpa"],
                                h["ps_max_hpa"], h["finite"]))
        f.write("\nGates: finite throughout; max|u| <= %.0f m/s; T in "
                "[%.0f, %.0f] K; ps in [%.0f, %.0f] hPa; q <= %.2f; "
                "time-mean jets in [%.0f, %.0f] m/s.\n" % (
                    GATES["u_max_ms"], tlo, thi, plo, phi_g,
                    GATES["q_max"], jlo, jhi))
        f.write("\n**Verdict: %s**\n" % ("PASS" if ok else "FAIL"))
    print("wrote", out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

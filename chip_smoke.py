#!/usr/bin/env python
"""On-card smoke test: the coupled main path and its numerics on a GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py           # phases a-d on one card
    python chip_smoke.py --four    # phase e only, on four cards

a  device: JAX's devices and the card's name and power limit (nvidia-smi)
b  main path: spmaster's run_T21.sh case — T21/L19 GCM at 900 s + 2 RICO
   LES of 64x64x160, --cplsurf, fused coupled step — for --steps 4 (five
   coupled steps, the restart overlap included); checks spifs.nc, the LES
   substep counts and timing.txt, prints compile and step times and the
   fused step's memory_analysis()
c  SL GCM: T159/L19 semi-Lagrangian steps (gather interpolation)
d  numerics: the same programs on the card and on the host CPU —
   one LES substep and the projection residual at 64x64x160, one T21
   GCM step, and the first coupled step's GCM tendencies
e  --four: the T21 case with 8 SP columns sharded les=4 over four cards
   against the same run on one card, in this one process

Exits 1 when a phase fails, and refuses (exit 2, no result line) when
JAX finds no GPU. The last line of a passing run is the JSON object
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import logging
import os
import shutil
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# run_T21.sh: two SP columns near Barbados, surface coupling on
T21_ARGS = ["--poly", "20", "-50", "10", "-50", "10", "-40", "20", "-40",
            "--numles", "2", "--gcmexp", "TEST", "--cplsurf"]
# 8 SP columns for the sharded fleet (phase e): 2 x 4 T21 columns east of
# the Antilles, same case otherwise
T21_8COL_ARGS = ["--poly", "12", "-60", "1", "-60", "1", "-38", "12", "-38",
                 "--gcmexp", "TEST", "--cplsurf"]
TEND_VARS = ("f_T", "f_SH", "f_U", "f_V")
# First coupled step, card vs CPU: 130-190 adaptive LES substeps per
# column. One substep already differs by up to ~1e-4 (the subgrid TKE,
# verify/oncard.py) from reduction order alone, and each substep feeds
# the next through the closure and the CFL-chosen dt, so the slab means
# the tendencies are built from drift apart through the step. Measured
# 6.1e-3 on the H100 (700 W); 2e-2 leaves room for another XLA:GPU
# autotuning choice (reduction order) and still fails any real defect,
# which moves a tendency by O(1).
TEND_TOL = 2e-2
# Phase e: the sharded and the one-card run execute the same per-instance
# program; only the partitioning differs (per-device reduction trees,
# collectives), so the first coupled step is held to the same bound.
FOUR_TOL = TEND_TOL


class _SubstepLog(logging.Handler):
    """Collects the driver's per-step LES substep counts."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.counts = []

    def emit(self, record):
        n = getattr(record, "n_substeps", None)
        if n is not None:
            self.counts.append(list(n))


def _run_spmaster(argv, odir):
    """spmaster's main path in this process: (rc, runner, substeps, s)."""
    import spmaster
    from sp_coupler.runtime import driver
    shutil.rmtree(odir, ignore_errors=True)
    handler = _SubstepLog()
    driver.log.addHandler(handler)
    level = driver.log.level
    driver.log.setLevel(logging.INFO)
    try:
        runner = spmaster.setup(argv + ["--odir", odir])
        t0 = time.perf_counter()
        rc = spmaster.run(runner)
        wall = time.perf_counter() - t0
    finally:
        driver.log.removeHandler(handler)
        driver.log.setLevel(level)
    for name in ("restart.npz", "restart.json"):   # large, not checked
        if os.path.exists(os.path.join(odir, name)):
            os.remove(os.path.join(odir, name))
    return rc, runner, handler.counts, wall


def _step_walls(odir):
    """Per-step wall [s] from timing.txt: the per-LES columns of a fused
    step row (start, 5 phase cols, one col per LES, host IO) sum to it."""
    with open(os.path.join(odir, "timing.txt")) as f:
        text = f.read()
    rows = text.split("# timing data", 1)[1].splitlines()[1:]
    return [sum(float(x) for x in r.split()[6:-1]) for r in rows]


def _columns_finite(path):
    from sp_coupler.io import spifs
    ds = spifs.open_reader(path)
    try:
        bad, n_rec = [], len(ds.variables["Time"][:])
        for col, grp in ds.groups.items():
            if "thl" not in grp.variables:
                continue
            for name, var in grp.variables.items():
                if not np.all(np.isfinite(var[...])):
                    bad.append("%s/%s" % (col, name))
        return n_rec, sorted(ds.groups, key=int), bad
    finally:
        ds.close()


def _fmt_mem(ma):
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ", ".join("%s=%.1f MB" % (f.replace("_size_in_bytes", ""),
                                      getattr(ma, f, 0) / 1e6)
                     for f in fields)


def phase_main(steps=4):
    odir = os.path.join(OUT, "t21_gpu")
    rc, runner, counts, wall = _run_spmaster(
        T21_ARGS + ["--steps", str(steps)], odir)
    assert rc == 0, "spmaster exited %d" % rc
    n_rec, cols, bad = _columns_finite(os.path.join(odir, "spifs.nc"))
    n_run = steps + 1            # spmaster runs one overlap step more
    print("  spifs.nc: %d records, columns %s, non-finite: %s"
          % (n_rec, cols, bad or "none"))
    assert n_rec == n_run and len(cols) == 2 and not bad
    print("  LES substeps per step and column: %s" % counts)
    assert len(counts) == n_run and all(n > 0 for c in counts for n in c)
    walls = _step_walls(odir)
    assert len(walls) == n_run, "timing.txt has %d step rows" % len(walls)
    print("  run wall %.1f s (initialize + %d steps + IO); per-step wall "
          "[s]: %s" % (wall, n_run, " ".join("%.3f" % w for w in walls)))
    print("  compile: steps 1-2 build the Euler-start and steady programs;"
          " steady step %.3f s, steps 1+2 minus 2 steady: %.1f s"
          % (np.median(walls[2:]), walls[0] + walls[1]
             - 2 * np.median(walls[2:])))
    t0 = time.perf_counter()
    compiled = runner.lower_fused_step().compile()
    print("  fused coupled step memory_analysis (lower+compile %.1f s): %s"
          % (time.perf_counter() - t0, _fmt_mem(compiled.memory_analysis())))
    return odir


def phase_sl(trunc=159, nlev=19):
    import jax
    from sp_coupler.models.gcm import model as gcm_model
    core = gcm_model.GCMCore(gcm_model.GCMConfig(
        trunc=trunc, nlev=nlev, dt=900.0, advection="sl"))
    print("  SL interpolation method: %s" % core.slg.method)
    assert core.slg.method == "gather"
    st = core.initial_state(seed=0)
    for first in (True, False):
        t0 = time.perf_counter()
        st = jax.block_until_ready(core.step(st, first=first))
        leaves = jax.tree.leaves(st)
        ok = all(np.all(np.isfinite(np.asarray(x))) for x in leaves)
        print("  T%d/L%d SL step (first=%s): %.2f s incl. compile, "
              "finite=%s" % (trunc, nlev, first,
                             time.perf_counter() - t0, ok))
        assert ok


def _check(name, errs, tol):
    worst = max(errs.values())
    print("  %-30s max rel err %.3e  tol %.1e  %s"
          % (name, worst, tol, "ok" if worst <= tol else "FAIL"))
    for k, v in sorted(errs.items(), key=lambda kv: -kv[1])[:8]:
        print("      %-40s %.3e" % (k, v))
    return worst <= tol


def phase_numerics(gpu_odir):
    import jax
    from sp_coupler.io import spifs
    from sp_coupler.verify import oncard
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    print("  matmul precision: HIGHEST on every f32 matmul of these paths "
          "(no TF32)")
    grid = oncard.rico_grid()
    ok = _check("LES substep 64x64x160",
                oncard.les_substep(gpu, cpu, grid), oncard.SUBSTEP_TOL)
    for dev in (gpu, cpu):
        r = oncard.projection_residual(dev, grid)
        print("  projection max|div|/(rho/dx) on %-4s %.3e  tol %.1e  %s"
              % (dev.platform, r, oncard.DIV_TOL,
                 "ok" if r <= oncard.DIV_TOL else "FAIL"))
        ok &= r <= oncard.DIV_TOL
    ok &= _check("T21/L19 GCM step", oncard.gcm_step(gpu, cpu),
                 oncard.GCM_STEP_TOL)
    if gpu_odir is None:
        print("  coupled tendencies: skipped (phase b failed)")
        return False
    cpu_odir = os.path.join(OUT, "t21_cpu")
    with jax.default_device(cpu):
        rc, _, _, wall = _run_spmaster(T21_ARGS + ["--steps", "0"],
                                       cpu_odir)
    assert rc == 0, "CPU spmaster exited %d" % rc
    print("  CPU reference run: 1 coupled step, %.1f s" % wall)
    a = spifs.open_reader(os.path.join(gpu_odir, "spifs.nc"))
    b = spifs.open_reader(os.path.join(cpu_odir, "spifs.nc"))
    try:
        errs = {"%s col %s" % (v, c): oncard.rel_err(
            a.groups[c].variables[v][0], b.groups[c].variables[v][0])
            for c in b.groups for v in TEND_VARS}
    finally:
        a.close()
        b.close()
    ok &= _check("1st coupled step tendencies", errs, TEND_TOL)
    return ok


def phase_four(steps=2):
    import jax
    from sp_coupler.io import spifs
    from sp_coupler.verify import oncard
    assert len(jax.devices()) >= 4, "need 4 devices, have %d" % len(
        jax.devices())
    out, walls = {}, {}
    for name, extra in (("one", []), ("les4", ["--mesh_les", "4"])):
        odir = os.path.join(OUT, "t21_8col_" + name)
        rc, _, counts, wall = _run_spmaster(
            T21_8COL_ARGS + ["--steps", str(steps)] + extra, odir)
        assert rc == 0, "spmaster (%s) exited %d" % (name, rc)
        walls[name] = _step_walls(odir)
        print("  %-5s run %.1f s; per-step wall [s]: %s; substeps %s"
              % (name, wall, " ".join("%.3f" % w for w in walls[name]),
                 counts))
        out[name] = os.path.join(odir, "spifs.nc")
    a, b = spifs.open_reader(out["les4"]), spifs.open_reader(out["one"])
    try:
        assert sorted(a.groups) == sorted(b.groups) and len(b.groups) == 8
        errs = {"%s col %s" % (v, c): oncard.rel_err(
            a.groups[c].variables[v][0], b.groups[c].variables[v][0])
            for c in b.groups for v in TEND_VARS + ("thl", "qt")}
    finally:
        a.close()
        b.close()
    return _check("les=4 vs one card, 1st step", errs, FOUR_TOL)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the les=4 sharded fleet on four cards")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)

    import jax
    from sp_coupler.runtime import compile_cache, device
    try:
        dev = device.require_gpu()
    except RuntimeError as e:
        print("chip_smoke: %s" % e, file=sys.stderr)
        return 2
    cache = compile_cache.configure()
    print("[a] devices: %s" % jax.devices())
    print("    device_kind: %s, count %d, compile cache %s"
          % (dev["kind"], dev["count"], cache))
    print("    nvidia-smi --query-gpu=name,power.limit:")
    print(dev["nvidia_smi"])

    if args.four:
        phases = [("e", "les=4 fleet on four cards", phase_four)]
    else:
        state = {}

        def main_path():
            state["odir"] = phase_main()

        phases = [("b", "main path", main_path),
                  ("c", "SL GCM T159", phase_sl),
                  ("d", "numerics vs CPU",
                   lambda: phase_numerics(state.get("odir")))]
    failed = []
    for tag, name, fn in phases:
        print("[%s] %s" % (tag, name), flush=True)
        t0 = time.perf_counter()
        try:
            ok = fn() is not False
        except Exception:
            traceback.print_exc(file=sys.stdout)
            ok = False
        print("[%s] %s in %.1f s" % (tag, "passed" if ok else "FAILED",
                                     time.perf_counter() - t0), flush=True)
        if not ok:
            failed.append(tag)
    if failed:
        print("chip_smoke: phases failed: %s" % ", ".join(failed))
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

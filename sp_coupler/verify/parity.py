"""CPU <-> GPU parity harness (two processes, one per backend).

BASELINE.json requires the coupled prognostic fields (GCM T/q/u/v profiles
and LES thl/qt/wind state, plus exchanged tendencies) to match a CPU run of
the same program allclose after N coupled steps. This module runs a fixed
coupled configuration on the *current* JAX backend, saves the trajectory
summary, and compares two such summaries.

Same-platform runs are bit-identical (one deterministic XLA program).
Cross-platform runs differ at float32 rounding level per step; turbulence
amplifies those differences, so the comparison targets (a) few-step full
3-D state closeness and (b) slab-profile / GCM-profile closeness with
tolerances that grow with step count.

Usage (two processes, then compare):
    JAX_PLATFORMS=cpu python -m sp_coupler.verify.parity run cpu.npz
    python -m sp_coupler.verify.parity run gpu.npz
    python -m sp_coupler.verify.parity compare cpu.npz gpu.npz

In-process checks at the reference widths are in verify/oncard.py.
"""

import sys

import numpy as np


def run(out_path, n_steps=3, trunc=10, nlev=8, les_n=16, les_nz=24,
        n_les=2, seed=7, les_dz=100.0, les_dx=200.0):
    """Run the standard parity configuration and save per-step summaries."""
    import jax
    import jax.numpy as jnp
    from ..models.gcm import model as gcm_model
    from ..models.les import (grid as lgrid, state as lstate,
                              step as lstep, diag as ldiag)
    from ..coupling import convert
    from ..coupling.coupler import CoupledStepFn

    print("parity run on platform:", jax.devices()[0].platform,
          file=sys.stderr)
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=trunc, nlev=nlev,
                                                 dt=600.0))
    grid = lgrid.LESGrid(nx=les_n, ny=les_n, nz=les_nz, dx=les_dx,
                         dy=les_dx, dz=les_dz)
    phys = lstep.LESPhysics()
    gcm_state = core.initial_state(seed=seed)
    cols = np.linspace(100, 350, n_les).astype(np.int32)

    @jax.jit
    def init_les(gstate):
        prof0 = core.column_profiles(gstate, jnp.asarray(cols))
        conv0 = jax.vmap(lambda p: convert.convert_profiles(
            p, grid.zf()))(prof0)
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(seed), i))(jnp.arange(n_les))
        return jax.vmap(lambda u, v, thl, qt, ps, k: lstate.init_state(
            grid, u, v, thl, qt, ps, k))(
            conv0.u, conv0.v, conv0.thl, conv0.qt, conv0.ps, keys)

    les_state = init_les(gcm_state)
    step_fn = CoupledStepFn(core, grid, phys, cols, dt_les=5.0,
                            n_substeps=0, seed=seed)
    prof = jax.vmap(lambda s: ldiag.slab_profiles(grid, s))(les_state)
    rain = jnp.zeros(n_les)

    out = {}
    for s in range(n_steps):
        res = step_fn(gcm_state, les_state, prof, rain, s, first=(s == 0))
        gcm_state, les_state, prof, rain, diag = jax.block_until_ready(res)
        diag = step_fn.unpack_diag(np.asarray(diag))
        # slab-mean profiles: the coupled observables
        out[f"step{s}_prof_THL"] = np.asarray(prof["THL"])
        out[f"step{s}_prof_QT"] = np.asarray(prof["QT"])
        out[f"step{s}_prof_U"] = np.asarray(prof["U"])
        # GCM column state
        out[f"step{s}_gcm_T"] = np.asarray(diag["gcm"]["T"])
        out[f"step{s}_gcm_U"] = np.asarray(diag["gcm"]["U"])
        out[f"step{s}_gcm_SH"] = np.asarray(diag["gcm"]["SH"])
        # turbulence statistics (chaos-robust): per-level std
        out[f"step{s}_std_thl"] = np.asarray(
            les_state.thl.std(axis=(2, 3)))
        out[f"step{s}_std_w"] = np.asarray(les_state.w.std(axis=(2, 3)))
    np.savez_compressed(out_path, **out)
    print("saved", out_path, file=sys.stderr)
    return out


# Tolerance model. The LES is chaotic: float32 rounding differences between
# backends (matmul pass structure, FFT algorithm, fusion order) grow with a
# Lyapunov time of minutes, so bit-parity across platforms is impossible by
# construction. The meaningful targets are (a) the coupled observables
# (slab-mean profiles, GCM columns) staying close in absolute terms and (b)
# the turbulence *statistics* agreeing. Per-step rel-to-max tolerances.
# One coupled "step" is already ~120 chaotic LES substeps.
PROFILE_TOL = [1e-2, 2e-2, 5e-2]
STD_TOL = [0.5, 1.0, 1.5]  # informational: std of a chaotic field


def compare(path_a, path_b, verbose=True):
    a = np.load(path_a)
    b = np.load(path_b)
    assert set(a.files) == set(b.files), "mismatched run configurations"
    failures = []
    for key in sorted(a.files):
        xa, xb = a[key], b[key]
        scale = np.abs(xa).max() + 1e-12
        diff = np.abs(xa - xb).max() / scale
        step = int(key[4])
        if "_std_" in key:
            tol = STD_TOL[min(step, len(STD_TOL) - 1)]
            enforce = False  # report-only: std of a chaotic field
        else:
            tol = PROFILE_TOL[min(step, len(PROFILE_TOL) - 1)]
            enforce = True
        ok = diff <= tol
        if verbose:
            print(f"{key:24s} max rel diff {diff:9.2e}  tol {tol:7.1e}  "
                  f"{'ok' if ok else ('FAIL' if enforce else 'note')}")
        if not ok and enforce:
            failures.append((key, diff, tol))
    if failures:
        print("PARITY FAIL: %d fields out of tolerance" % len(failures))
        return False
    print("PARITY OK: all enforced fields within tolerance")
    return True


def main(argv):
    if argv[0] == "run":
        if len(argv) > 2 and argv[2] == "real":
            # BASELINE case size: T21/L19 GCM, 64x64x160 LES at 200 m /
            # 25 m spacing (run_T21_sockets.sh + dales-input/namoptions)
            n_steps = int(argv[3]) if len(argv) > 3 else 10
            run(argv[1], n_steps=n_steps, trunc=21, nlev=19, les_n=64,
                les_nz=160, n_les=2, les_dz=25.0)
        else:
            run(argv[1], *(int(x) for x in argv[2:]))
        return 0
    if argv[0] == "compare":
        return 0 if compare(argv[1], argv[2]) else 1
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

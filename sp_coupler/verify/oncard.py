"""The same computation on the GPU and on the host CPU, compared.

Each check builds its inputs once on the host, runs one jitted program on
each of two devices (inputs committed there with device_put) and returns
the largest difference of every output relative to that output's largest
magnitude, to be read beside the check's tolerance. chip_smoke.py runs
these at the reference widths; tests/test_gpu.py runs them as tests
marked ``gpu``.

Tolerances come from float32 round-off (2**-24 ~ 6e-8 per operation)
and reduction order: XLA:GPU sums in another order than XLA:CPU and
contracts multiply-adds into FMAs, so every output of a deep chain of
f32 operations differs by a few ulps times the depth of that chain.
Every matmul on these paths runs at Precision.HIGHEST (no TF32).
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..models.les import (grid as lgrid, state as lstate, step as lstep,
                          poisson, advect)
from ..models.les.state import LESForcing

# One substep (3 RK stages, 3 projections) is ~1e3 dependent f32
# operations deep, and the projection's eigenbasis solve multiplies
# round-off by its conditioning (~1e2); 1e3 * 1e2 * 6e-8 ~ 6e-3 bounds
# it from above. Measured on an H100 (700 W): 1.2e-4, in the subgrid TKE.
SUBSTEP_TOL = 1e-3
# max|div(rho u)| after the projection, in units of max(rho)/dx: the
# f32 eigenbasis solve plus one refinement pass leaves ~5e-6 (H100 at
# 700 W and CPU alike); a TF32 solve leaves ~1e-4. The same bound as the
# CPU tests (tests/test_les.py).
DIV_TOL = 2e-5
# One GCM step is a few hundred operations deep through spectral
# transforms whose Legendre sums run over ~30 terms at T21. Measured on
# an H100 (700 W): 2.0e-5, in the diagnosed cloud fraction.
GCM_STEP_TOL = 1e-4


def rel_err(a, b):
    """max|a - b| / max|b| (absolute when b is all zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def run_on(device, fn, *args):
    """fn(*args) jitted on `device`; outputs as host numpy."""
    args = jax.device_put(args, device)
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def rico_grid():
    """The reference RICO LES: 64 x 64 x 160 at 200 m / 25 m."""
    return lgrid.LESGrid()


def rico_state(grid):
    """Idealized RICO sounding (dales-input/prof.inp.001) + perturbations,
    built on the host CPU."""
    zf = (np.arange(grid.nz) + 0.5) * grid.dz
    thl = 297.9 + np.where(zf < 740.0, 0.0, (zf - 740.0) * 19.1 / 3260.0)
    qt = np.where(zf < 740.0, 16.0 + (13.8 - 16.0) * zf / 740.0,
                  13.8 + (2.4 - 13.8) * (zf - 740.0) / 3260.0) * 1e-3
    u = -9.9 + 2e-3 * zf
    v = np.full(grid.nz, -3.8)
    prof = [jnp.asarray(x, jnp.float32) for x in (u, v, thl, qt)]
    with jax.default_device(jax.devices("cpu")[0]):
        st = lstate.init_state(grid, *prof, 1.0e5,
                               jax.random.PRNGKey(0))
        return jax.tree.map(np.asarray, st)


def _forcing(nz):
    return jax.tree.map(np.asarray, LESForcing.zeros(nz)._replace(
        wthl=jnp.asarray(0.01, jnp.float32),
        wqt=jnp.asarray(5e-5, jnp.float32)))


def les_substep(device, ref, grid):
    """One 3 s LES substep on both devices: {field: rel_err}."""
    phys = lstep.LESPhysics()
    state, forcing = rico_state(grid), _forcing(grid.nz)

    def fn(s, f):
        solver = poisson.build_solver(grid, s.rhobf, s.rhobh)
        return lstep.substep(grid, phys, s, f, 3.0, solver=solver)[0]

    a, b = run_on(device, fn, state, forcing), run_on(ref, fn, state, forcing)
    return {k: rel_err(getattr(a, k), getattr(b, k))
            for k in ("u", "v", "w", "thl", "qt", "qr", "e12", "ustar")}


def projection_residual(device, grid):
    """max|div(rho u)| / (max rho / dx) after projecting a perturbed
    velocity field on `device`."""
    s = rico_state(grid)
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    with jax.default_device(jax.devices("cpu")[0]):
        u = np.asarray(s.u + 0.5 * jax.random.normal(ks[0], s.u.shape))
        v = np.asarray(s.v + 0.5 * jax.random.normal(ks[1], s.v.shape))
        w = np.asarray(jnp.asarray(s.w).at[1:-1].set(
            0.3 * jax.random.normal(ks[2], s.w[1:-1].shape)))

    def fn(rhobf, rhobh, u, v, w):
        u2, v2, w2, _ = poisson.project(grid, rhobf, rhobh, u, v, w, 5.0)
        return jnp.max(jnp.abs(advect.divergence(grid, rhobf, rhobh,
                                                 u2, v2, w2)))

    div = run_on(device, fn, s.rhobf, s.rhobh, u, v, w)
    return float(div) / (float(np.max(s.rhobf)) / grid.dx)


def gcm_step(device, ref):
    """One T21/L19 GCM step (Euler start, 900 s) on both devices:
    {state leaf: rel_err}."""
    from ..models.gcm import model as gcm_model
    core = gcm_model.GCMCore(gcm_model.GCMConfig(trunc=21, nlev=19,
                                                 dt=900.0))
    with jax.default_device(jax.devices("cpu")[0]):
        st0 = jax.tree.map(np.asarray, core.initial_state(seed=0))
    outs = []
    for dev in (device, ref):
        with jax.default_device(dev):
            st = core.step(jax.device_put(st0, dev), first=True)
            outs.append(jax.tree.map(np.asarray, st))
    flat_a = jax.tree_util.tree_flatten_with_path(outs[0])[0]
    flat_b = jax.tree.leaves(outs[1])
    return {jax.tree_util.keystr(p): rel_err(a, b)
            for (p, a), b in zip(flat_a, flat_b)
            if np.issubdtype(np.asarray(a).dtype, np.floating)}

"""LES time stepping: tendency assembly + Wicker-Skamarock RK3 + projection.

The substep is the hot path of the whole framework (the reference spends
minutes per coupled step inside DALES's evolve_model, splib.py:566). One
substep = 3 RK stages, each: saturation adjustment -> advection + subgrid +
buoyancy + forcings + microphysics -> pressure projection. Everything is
jit-compiled; the fixed substep count per GCM step makes the whole evolve a
lax.scan (XLA unrolls nothing, compiles once).
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ... import constants as c
from ...utils import thermo
from . import advect, subgrid, poisson, micro
from .advect import sp, sm, X, Y, Z
from .state import LESState, LESForcing

QT_FORCING_GLOBAL = 0    # uniform profile tendency (reference "sp" mode)
QT_FORCING_VARIANCE = 1  # global + coupler-side variability nudge
QT_FORCING_LOCAL = 2     # tendency distributed proportionally to local qt
QT_FORCING_STRONG = 3    # proportional with saturation-aware clipping


class LESPhysics(NamedTuple):
    """Static physics configuration (hashable, jit static arg)."""

    scheme: str = "hybrid52"
    subgrid: str = "tke"             # "tke" (DALES default) | "smagorinsky"
    f_coriolis: float = 0.0
    sponge_depth: float = 750.0      # m, nudge-to-mean layer below the lid
    sponge_tau: float = 120.0        # s, strongest relaxation rate at the top
    qt_forcing: int = QT_FORCING_GLOBAL
    mphys: micro.MicroParams = micro.MicroParams()
    n_sat_iter: int = 2


def thermodynamics(state):
    """Saturation adjustment on the whole volume: (T, ql, qsat, thv)."""
    p = state.pbf[:, None, None]
    T, ql, qs = thermo.sat_adjust(state.thl, state.qt, p, n_iter=2)
    th = T * thermo.iexner(p)
    qv = state.qt - ql
    thv = th * (1.0 + c.eps_i * qv - ql - state.qr)
    return T, ql, qs, thv


def _apply_qt_forcing(state, forcing, mode):
    """Distribute the slab-mean qt tendency over the volume (DALES
    qt_forcing modes, modfac.py:70-73)."""
    f = forcing.f_qt[:, None, None]
    if mode == QT_FORCING_GLOBAL or mode == QT_FORCING_VARIANCE:
        return jnp.broadcast_to(f, state.qt.shape)
    qt_mean = jnp.mean(state.qt, axis=(Y, X), keepdims=True)
    scale = state.qt / jnp.maximum(qt_mean, 1e-10)
    if mode == QT_FORCING_LOCAL:
        return f * scale
    # STRONG: proportional for drying (keeps qt positive), uniform for
    # moistening
    return jnp.where(f < 0, f * scale, jnp.broadcast_to(f, state.qt.shape))


def tendencies(grid, phys, state, forcing, dt):
    """All non-pressure tendencies. Returns a dict keyed like the state."""
    T, ql, qs, thv = thermodynamics(state)
    rhobf, rhobh = state.rhobf, state.rhobh

    # one reduction pass for every slab mean needed this stage
    means = jnp.mean(jnp.stack([thv, state.thl, state.qt]), axis=(Y + 1, X + 1),
                     keepdims=True)
    thv_m, thl_m, qt_m = means[0], means[1], means[2]

    # eddy viscosities first: every flux below consumes them
    if phys.subgrid == "tke":
        Km, Kh, lam, S2, N2 = subgrid.tke_viscosity(grid, state, thv, thv_m)
    else:
        Km, Kh = subgrid.eddy_viscosity(grid, state, thv)

    # all advected+diffused scalars in ONE stacked pass: u, v, w, K are
    # read once and the shifted-flux graph is shared across the batch
    # (thl, qt, qr share Kh; e12 diffuses with 2 Km)
    scalars = jnp.stack([state.thl, state.qt, state.qr, state.e12])
    Ks = jnp.stack([Kh, Kh, Kh, 2.0 * Km])
    adv_all = jax.vmap(
        lambda s: advect.advect_scalar(grid, rhobf, rhobh, state.u,
                                       state.v, state.w, s,
                                       phys.scheme))(scalars)
    zero_sf = jnp.zeros_like(forcing.wthl)
    sfluxes = jnp.stack([forcing.wthl + zero_sf, forcing.wqt + zero_sf,
                         zero_sf, zero_sf])
    diff_all = jax.vmap(
        lambda K, s, sf: subgrid.diffuse_scalar(grid, rhobf, rhobh, K, s,
                                                surf_flux=sf))(
        Ks, scalars, sfluxes)
    dthl = adv_all[0] + diff_all[0]
    dqt = adv_all[1] + diff_all[1]
    dqr = adv_all[2] + diff_all[2]
    de12_all = adv_all[3] + diff_all[3]

    # momentum advection + subgrid stress (+ surface drag correction)
    du = advect.advect_u(grid, rhobf, rhobh, state.u, state.v, state.w)
    dv = advect.advect_v(grid, rhobf, rhobh, state.u, state.v, state.w)
    dw = advect.advect_w(grid, rhobf, rhobh, state.u, state.v, state.w)
    tu, tv, tw, ustar = subgrid.diffuse_momentum(grid, rhobf, rhobh, Km,
                                                 state, forcing.z0m)
    du = du + tu
    dv = dv + tv
    dw = dw + tw

    # buoyancy on interior w faces, relative to the slab mean
    b_cent = c.grav * (thv - thv_m) / jnp.maximum(thv_m, 1.0)
    b_face = 0.5 * (b_cent[1:] + b_cent[:-1])
    dw = dw.at[1:-1].add(b_face)

    # TKE sources
    if phys.subgrid == "tke":
        de12 = de12_all + subgrid.tke_sources(grid, Km, Kh, lam, S2, N2,
                                              state.e12)
    else:
        de12 = jnp.zeros_like(state.e12)

    # coriolis (off in the reference RICO case, namoptions lcoriol=false)
    if phys.f_coriolis != 0.0:
        vc_at_u = 0.25 * (state.v + sp(state.v, Y) + sm(state.v, X)
                          + sp(sm(state.v, X), Y))
        uc_at_v = 0.25 * (state.u + sp(state.u, X) + sm(state.u, Y)
                          + sp(sm(state.u, Y), X))
        du = du + phys.f_coriolis * vc_at_u
        dv = dv - phys.f_coriolis * uc_at_v

    # coupler forcings (profile tendencies, spcpl.py:328-347)
    du = du + forcing.f_u[:, None, None]
    dv = dv + forcing.f_v[:, None, None]
    dthl = dthl + forcing.f_thl[:, None, None]
    dqt = dqt + _apply_qt_forcing(state, forcing, phys.qt_forcing)

    # microphysics
    mdqt, mdqr, mdthl, surf_rain = micro.rain_tendencies(
        grid, phys.mphys, rhobf, T, state.pbf[:, None, None],
        state.qt - ql, ql, state.qr, dt)
    dqt = dqt + mdqt
    dqr = dqr + mdqr
    dthl = dthl + mdthl

    # sponge layer: relax to slab means near the lid (igrw_damp equivalent)
    zf = (jnp.arange(grid.nz, dtype=state.u.dtype) + 0.5) * grid.dz
    zs = grid.zsize - phys.sponge_depth
    rate = jnp.clip((zf - zs) / phys.sponge_depth, 0.0, 1.0) / phys.sponge_tau
    rate = rate[:, None, None]

    uv_means = jnp.mean(jnp.stack([state.u, state.v]),
                        axis=(Y + 1, X + 1), keepdims=True)
    du = du - rate * (state.u - uv_means[0])
    dv = dv - rate * (state.v - uv_means[1])
    dthl = dthl - rate * (state.thl - thl_m)
    dqt = dqt - rate * (state.qt - qt_m)
    rate_h = jnp.clip(((jnp.arange(grid.nz + 1, dtype=state.u.dtype)
                        * grid.dz) - zs) / phys.sponge_depth, 0.0, 1.0)
    dw = dw - (rate_h / phys.sponge_tau)[:, None, None] * state.w

    # max eddy viscosity for the caller's Peclet dt limit. DALES
    # tstep_update bounds dt with ekm ONLY (not ekh — scalar diffusion
    # with Kh ~ 3 Km runs at diffusion number ~0.3, stable inside RK3),
    # so using max(Km, Kh) here would cut dt ~3x below the reference.
    kmax = jnp.max(Km)
    return dict(u=du, v=dv, w=dw, thl=dthl, qt=dqt, qr=dqr, e12=de12,
                ustar=ustar, surf_rain=surf_rain, kmax=kmax)


def substep(grid, phys, state: LESState, forcing: LESForcing, dt,
            solver=None, skip_projection=False):
    """One full LES time step: RK3 (Wicker-Skamarock) + projection.

    Returns (state, kmax) with kmax the final stage's max eddy diffusivity,
    for the adaptive driver's Peclet limit. Pass a prebuilt
    poisson.build_solver on the hot path (evolve does) so the pressure
    eigenfactorization runs once per coupled step, not per stage.

    ``skip_projection`` (bench-only, bench.py phase accounting): drop the
    pressure solve so the projection's IN-CONTEXT cost is the timing
    difference against the full substep — never use for physics.
    """
    def stage(s, frac, base):
        t = tendencies(grid, phys, s, forcing, dt)
        u = base.u + frac * dt * t["u"]
        v = base.v + frac * dt * t["v"]
        w = base.w + frac * dt * t["w"]
        if not skip_projection:
            u, v, w, _ = poisson.project(grid, s.rhobf, s.rhobh, u, v,
                                         w, frac * dt, solver=solver)
        return s._replace(
            u=u, v=v, w=w,
            thl=base.thl + frac * dt * t["thl"],
            qt=jnp.maximum(base.qt + frac * dt * t["qt"], 0.0),
            qr=jnp.maximum(base.qr + frac * dt * t["qr"], 0.0),
            e12=jnp.maximum(base.e12 + frac * dt * t["e12"],
                            subgrid.E12_MIN),
            ustar=t["ustar"],
        ), t

    s1, _ = stage(state, 1.0 / 3.0, state)
    s2, _ = stage(s1, 0.5, state)
    s3, t3 = stage(s2, 1.0, state)
    return s3._replace(
        ps=state.ps + dt * 0.0,  # surface pressure tendency handled in evolve
        rain=state.rain + dt * t3["surf_rain"],
        time=state.time + dt,
    ), t3["kmax"]


def evolve(grid, phys, state: LESState, forcing: LESForcing, dt, n_steps):
    """Advance n_steps substeps of length dt under constant coupler forcing.

    The surface-pressure tendency from the coupler (set_tendency_surface_
    pressure, spcpl.py:345) integrates ps linearly over the interval; the
    anelastic base state is rebuilt once at the start from the current
    slab-mean state (cheap [nz] scan).
    """
    # apply ps tendency for the whole interval up front, rebuild base state
    from .state import base_state  # local import to avoid cycle

    ps_new = state.ps + forcing.f_ps * dt * n_steps
    thl0 = jnp.mean(state.thl, axis=(Y, X))
    qt0 = jnp.mean(state.qt, axis=(Y, X))
    pbf, pbh, rhobf, rhobh = base_state(grid, thl0, qt0, ps_new)
    state = state._replace(ps=ps_new, pbf=pbf, pbh=pbh,
                           rhobf=rhobf, rhobh=rhobh)
    solver = poisson.build_solver(grid, rhobf, rhobh)

    def body(s, _):
        return substep(grid, phys, s, forcing, dt, solver=solver)[0], ()

    state, _ = jax.lax.scan(body, state, None, length=n_steps)
    return state


# Above this size, pacing instances independently (lax.map) is assumed to
# beat lock-step vmap batching, whose single while_loop runs every instance
# until the SLOWEST one finishes (the reference's instances are fully
# independent processes, splib.py:554-593). The threshold assumes one
# 64x64x160 instance fills the device; it was set on an earlier
# accelerator and has not been measured on the H100 (ROADMAP Speed
# item 7 owns it).
SERIAL_MIN_POINTS = 512 * 1024


def serial_fleet_default(grid):
    """Whether per-instance serial pacing is the right default."""
    return grid.nx * grid.ny * grid.nz >= SERIAL_MIN_POINTS


def map_fleet(one, states, forcings, serial):
    """Apply `one(state, forcing)` across the fleet axis.

    serial=False: vmap — one batched while_loop, every instance does
    max_i(n_substeps_i) iterations of full-fleet traffic.
    serial=True: lax.map — each instance runs its own adaptive loop to
    completion; total device work is sum_i(n_i) single-instance
    iterations, which is never more and is strictly less whenever CFL
    heterogeneity makes substep counts uneven.
    """
    if serial:
        return jax.lax.map(lambda sf: one(*sf), (states, forcings))
    return jax.vmap(one)(states, forcings)


def evolve_adaptive(grid, phys, state: LESState, forcing: LESForcing,
                    t_end, dt_max=15.0, cfl=0.7, dt_min=0.2, peclet=0.1):
    """Advance to exactly t_end with CFL-adaptive substeps (jit-safe).

    Replicates DALES's adaptive time stepping (namoptions ladaptive=.true.,
    courant=0.7, peclet=0.1; evolve_model(t, exactEnd=True), splib.py:566)
    as a lax.while_loop: each iteration picks
    dt = min(cfl / max_cell(|u|/dx + |v|/dy + |w|/dz),
             peclet * min(dx, dy, dz)^2 / max(ekm)),
    clipped to [dt_min, dt_max] and to the remaining interval; max(ekm)
    comes from the previous substep's closure, exactly as in DALES
    tstep_update (modtstep.f90: ekm * rdt / minval((/dzh,dx,dy/))**2).
    Returns (state, n_substeps_taken, n_dtmin_clamped): the third output
    counts substeps whose stability-required dt fell BELOW dt_min and was
    clamped — a flagged instability indicator (the driver reports it; the
    reference's DALES would simply blow up, splib.py:300-304).
    """
    from .state import base_state

    span = t_end - state.time
    ps_new = state.ps + forcing.f_ps * span
    thl0 = jnp.mean(state.thl, axis=(Y, X))
    qt0 = jnp.mean(state.qt, axis=(Y, X))
    pbf, pbh, rhobf, rhobh = base_state(grid, thl0, qt0, ps_new)
    state = state._replace(ps=ps_new, pbf=pbf, pbh=pbh,
                           rhobf=rhobf, rhobh=rhobh)
    solver = poisson.build_solver(grid, rhobf, rhobh)

    def cond(carry):
        s, n, nclamp, kmax = carry
        return s.time < t_end - 1e-3

    min2 = min(grid.dx, grid.dy, grid.dz) ** 2

    def body(carry):
        s, n, nclamp, kmax = carry
        # per-cell Courant number like DALES (max over cells of the summed
        # directional CFL), not the over-conservative sum of global maxima
        rate_cell = (jnp.abs(s.u) / grid.dx + jnp.abs(s.v) / grid.dy
                     + jnp.abs(0.5 * (s.w[1:] + s.w[:-1])) / grid.dz)
        rate = jnp.max(rate_cell)
        dt = jnp.minimum(cfl / jnp.maximum(rate, 1e-6),
                         peclet * min2 / jnp.maximum(kmax, 1e-9))
        nclamp = nclamp + (dt < dt_min).astype(jnp.int32)
        dt = jnp.clip(dt, dt_min, dt_max)
        dt = jnp.minimum(dt, t_end - s.time)
        s, kmax = substep(grid, phys, s, forcing, dt, solver=solver)
        return s, n + 1, nclamp, kmax

    # first-substep bound from the closure's form Km = cm * lam * e12,
    # lam <= Delta
    delta = (grid.dx * grid.dy * grid.dz) ** (1.0 / 3.0)
    k0 = subgrid.CM * delta * jnp.max(state.e12)
    # the clamp counter becomes device-varying inside the loop body (it
    # depends on the sharded state); seed it from the state so the carry's
    # varying-axes type matches under shard_map
    nclamp0 = (0.0 * k0).astype(jnp.int32)
    state, n, nclamp, _ = jax.lax.while_loop(
        cond, body, (state, jnp.zeros((), jnp.int32), nclamp0, k0))
    return state, n, nclamp

"""Hydrostatic primitive-equation spectral dycore (sigma coords, semi-implicit).

Vorticity-divergence form on the sphere (Bourke 1974 / Hoskins & Simmons
1975 lineage), semi-implicit leapfrog with Robert-Asselin filter and
del^4 hyperdiffusion. This is the stand-in for OpenIFS's
dynamics consumed by the reference through the evolve_model_* split
(splib.py:186-188, 296-299, 335): all transforms are einsums, all
level couplings are small matmuls, the whole step jit-compiles to one
XLA program.

State layout: packed-real spectral coefficients [L, M, N, 2] (level-major,
last axis = re/im — see spharm.py: real einsums only, no complex
arithmetic); moisture and cloud tracers are spectrally
advected with grid-space clipping in the physics layer.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST

from ... import constants as c


class SpectralState(NamedTuple):
    """Prognostic spectral coefficients at one time level."""

    vort: jnp.ndarray    # [L, M, N, 2] packed real (re, im)
    div: jnp.ndarray     # [L, M, N, 2]
    T: jnp.ndarray       # [L, M, N, 2]
    lnps: jnp.ndarray    # [M, N, 2]
    q: jnp.ndarray       # [L, M, N, 2] specific humidity (vapor, "SH")
    ql: jnp.ndarray      # [L, M, N, 2] cloud liquid
    qi: jnp.ndarray      # [L, M, N, 2] cloud ice
    a: jnp.ndarray       # [L, M, N, 2] cloud fraction

    @classmethod
    def zeros(cls, nlev, M, N, dtype=jnp.float32):
        """Packed-real spectral coefficients [..., M, N, 2] (re, im)."""
        z3 = jnp.zeros((nlev, M, N, 2), dtype)
        z2 = jnp.zeros((M, N, 2), dtype)
        return cls(vort=z3, div=z3, T=z3, lnps=z2, q=z3, ql=z3, qi=z3, a=z3)

    def map(self, f):
        return SpectralState(*[f(x) for x in self])


class GridFields(NamedTuple):
    """Grid-space view of the state plus diagnostics (all [L, nlat, nlon])."""

    u: jnp.ndarray
    v: jnp.ndarray
    T: jnp.ndarray
    q: jnp.ndarray
    ql: jnp.ndarray
    qi: jnp.ndarray
    a: jnp.ndarray
    lnps: jnp.ndarray      # [nlat, nlon]
    omega_p: jnp.ndarray   # omega / p
    vort: jnp.ndarray
    div: jnp.ndarray


def _hybrid_coeffs_grid(vc, lnps):
    """Per-gridpoint hybrid coefficients (None in sigma mode).

    Returns dict with [L, nlat, nlon] entries: dpt (layer thickness per
    unit ps), lnr, alpha, wp (= Bbar*ps/pf, the surface-following weight
    of grad(ln p) at full levels; == 1 in sigma coordinates)."""
    from ... import constants as c
    if not vc.hybrid:
        return None
    ps = c.pref0 * jnp.exp(lnps)                       # [nlat, nlon]
    hc = vc.hybrid_coeffs(ps)
    Bbar = 0.5 * (vc.B[1:] + vc.B[:-1])
    wp = Bbar[:, None, None] * ps[None] / hc["pf"]
    return dict(dpt=hc["dpt"], lnr=hc["lnr"], alpha=hc["alpha"], wp=wp)


def to_grid(sht, vc, s: SpectralState, diag=True) -> GridFields:
    """Grid view of a spectral state. diag=False skips the diagnostic
    fields (omega_p, grid vort/div) — used for the SL departure-time
    state, where only the prognostic fields are interpolated; the skip
    saves ~1 GB of synthesis temporaries at TL639/L60."""
    u, v = sht.uv_from_vort_div(s.vort, s.div)
    T = sht.synthesize(s.T)
    q = sht.synthesize(s.q)
    ql = sht.synthesize(s.ql)
    qi = sht.synthesize(s.qi)
    a = sht.synthesize(s.a)
    lnps = sht.synthesize(s.lnps)
    if not diag:
        return GridFields(u=u, v=v, T=T, q=q, ql=ql, qi=qi, a=a,
                          lnps=lnps, omega_p=None, vort=None, div=None)
    vort = sht.synthesize(s.vort)
    div = sht.synthesize(s.div)
    dpx, dpy = sht.grad(s.lnps)
    vgrad = u * dpx[None] + v * dpy[None]
    hc = _hybrid_coeffs_grid(vc, lnps)
    if hc is None:
        C = div + vgrad
        omega_p = (vgrad - jnp.einsum("kj,j...->k...", vc.Pmat, C,
                                      precision=_PREC))
    else:
        # (omega/p)_k = wp_k v.grad(lnps)
        #   - (1/dpt_k)[lnr_k sum_{j<k} Ct_j + alpha_k Ct_k],
        # Ct_j = dpt_j D_j + dB_j v.grad(lnps)  (per-unit-ps mass div);
        # reduces exactly to the Pmat form on sigma levels
        Ct = hc["dpt"] * div + vc.dB[:, None, None] * vgrad
        csum_ex = jnp.cumsum(Ct, axis=0) - Ct
        omega_p = (hc["wp"] * vgrad
                   - (hc["lnr"] * csum_ex + hc["alpha"] * Ct) / hc["dpt"])
    return GridFields(u=u, v=v, T=T, q=q, ql=ql, qi=qi, a=a, lnps=lnps,
                      omega_p=omega_p, vort=vort, div=div)


def _vert_advect(vc, sdot_half, X, dpt=None):
    """(eta_dot dX/d-eta)_k with sdot_half [L+1, ...] in per-unit-ps
    pressure units (zero at both ends); dpt = actual layer thickness per
    unit ps (defaults to the sigma constants)."""
    dX_up = X - jnp.concatenate([X[:1], X[:-1]], 0)      # X_k - X_{k-1}
    dX_dn = jnp.concatenate([X[1:], X[-1:]], 0) - X      # X_{k+1} - X_k
    ds = vc.ds[:, None, None] if dpt is None else dpt
    return 0.5 / ds * (sdot_half[1:] * dX_dn + sdot_half[:-1] * dX_up)


def tendencies(sht, vc, s: SpectralState, f_coriolis_grid):
    """Explicit (nonlinear + linear) tendencies at time t, spectral space.

    Returns (N: SpectralState of tendencies, g: GridFields at t).
    """
    g = to_grid(sht, vc, s)
    dpx, dpy = sht.grad(s.lnps)
    vgrad = g.u * dpx[None] + g.v * dpy[None]
    hc = _hybrid_coeffs_grid(vc, g.lnps)
    if hc is None:
        ds = vc.ds[:, None, None]
        Ct = (g.div + vgrad) * ds           # per-unit-ps mass divergence
        dpt = None
        Bh = vc.sh                           # sigma: B == sigma
        wp = 1.0
    else:
        dpt = hc["dpt"]
        Ct = g.div * dpt + vc.dB[:, None, None] * vgrad
        Bh = vc.B
        wp = hc["wp"]
    # surface pressure tendency and eta-dot (pressure units per unit ps)
    dpi_dt = -jnp.sum(Ct, axis=0)                        # [nlat, nlon]
    csum = jnp.cumsum(Ct, axis=0)                        # sum_{j<=k}
    total = csum[-1:]
    # half levels 0..L: (eta_dot dp/d-eta)/ps at half level k
    sdot_int = Bh[1:-1, None, None] * total - csum[:-1]
    zero = jnp.zeros_like(sdot_int[:1])
    sdot = jnp.concatenate([zero, sdot_int, zero], axis=0)  # [L+1]

    Tp = g.T - vc.tref                                   # T perturbation
    abs_vort = g.vort + f_coriolis_grid[None]

    Fu = (abs_vort * g.v - _vert_advect(vc, sdot, g.u, dpt)
          - c.rd * Tp * wp * dpx[None])
    Fv = (-abs_vort * g.u - _vert_advect(vc, sdot, g.v, dpt)
          - c.rd * Tp * wp * dpy[None])
    N_vort, divF = sht.vort_div_from_uv(Fu, Fv)

    E = 0.5 * (g.u ** 2 + g.v ** 2)
    if hc is None:
        # sigma: geopotential is linear in T -> the reference-state G
        # matrix IS the exact operator (spectral-space matmul)
        phi_nl = jnp.einsum("kj,j...->k...", vc.G.astype(s.T.dtype), s.T,
                            precision=_PREC)
        lin = (sht.analyze(E).astype(s.T.dtype) + phi_nl
               + c.rd * vc.tref * s.lnps[None])
    else:
        # hybrid: Phi depends nonlinearly on ps through lnr/alpha —
        # compute it pointwise in grid space and analyze; the
        # semi-implicit correction still uses the reference-state G
        # (delta form handles the difference explicitly)
        T_last = jnp.moveaxis(g.T, 0, -1)                # [lat, lon, L]
        phi_grid = vc.geopotential_full(
            T_last, lnr=jnp.moveaxis(hc["lnr"], 0, -1),
            alpha=jnp.moveaxis(hc["alpha"], 0, -1))
        phi_grid = jnp.moveaxis(phi_grid, -1, 0)
        lin = (sht.analyze(E + phi_grid).astype(s.T.dtype)
               + c.rd * vc.tref * s.lnps[None])
    N_div = divF - sht.laplacian[..., None] * lin

    # thermodynamic equation: flux-form horizontal advection of T'
    _, divTflux = sht.vort_div_from_uv(g.u * Tp, g.v * Tp)
    N_T_grid = (Tp * g.div - _vert_advect(vc, sdot, g.T, dpt)
                + c.kappa * g.T * g.omega_p)
    N_T = -divTflux + sht.analyze(N_T_grid).astype(s.T.dtype)

    N_lnps = sht.analyze(dpi_dt).astype(s.lnps.dtype)

    def scalar_adv(x_spec, x_grid):
        _, divflux = sht.vort_div_from_uv(g.u * x_grid, g.v * x_grid)
        rest = x_grid * g.div - _vert_advect(vc, sdot, x_grid, dpt)
        return -divflux + sht.analyze(rest).astype(x_spec.dtype)

    N_q = scalar_adv(s.q, g.q)
    N_ql = scalar_adv(s.ql, g.ql)
    N_qi = scalar_adv(s.qi, g.qi)
    N_a = scalar_adv(s.a, g.a)

    N = SpectralState(vort=N_vort, div=N_div,
                      T=N_T, lnps=N_lnps, q=N_q, ql=N_ql, qi=N_qi, a=N_a)
    return N, g


def semi_implicit_step(sht, vc, now: SpectralState, prev: SpectralState,
                       N: SpectralState, dt2):
    """Leapfrog step prev -> new over window dt2 (=2*dt; =dt on step one).

    Delta-form semi-implicit treatment of the linear gravity-wave terms
    (G T, R Tref lnps in the divergence eq; W D in T; -b.D in lnps).
    """
    h = dt2 / 2.0
    Minv = vc.implicit_inverse(h, sht.trunc)            # [Nn, L, L]
    lam = (-sht.laplacian)[..., None]                   # +n(n+1)/a^2, [M, N, 1]
    G = vc.G
    W = vc.W
    b = vc.b
    Tref = vc.tref

    # explicit candidates
    T_star = prev.T + dt2 * N.T
    pi_star = prev.lnps + dt2 * N.lnps
    # explicit parts of (X+ + X- - 2 X^t) entering the implicit correction
    dT_expl = 2.0 * (prev.T - now.T) + dt2 * N.T
    dPi_expl = 2.0 * (prev.lnps - now.lnps) + dt2 * N.lnps
    rhs = (prev.div + dt2 * N.div
           + h * lam[None] * (jnp.einsum("kj,j...->k...",
                                         G.astype(now.T.dtype), dT_expl,
                                         precision=_PREC)
                              + c.rd * Tref * dPi_expl[None]))
    # (I - A) D+ = rhs + A (prev.div - 2 now.div),
    # A = h^2 lam (G W - R Tref 1 b^T)  per spectral mode
    GW = (G @ W - c.rd * Tref * jnp.outer(jnp.ones(vc.nlev), b)).astype(
        now.div.dtype)
    corr = prev.div - 2.0 * now.div
    Acorr = (h * h) * lam[None] * jnp.einsum("kj,j...->k...", GW, corr, precision=_PREC)
    x = rhs + Acorr
    div_new = jnp.einsum("nlj,jmnc->lmnc", Minv.astype(x.dtype), x,
                         precision=_PREC)

    dDiv = div_new + prev.div - 2.0 * now.div
    T_new = T_star + h * jnp.einsum("kj,j...->k...", W.astype(x.dtype),
                                    dDiv, precision=_PREC)
    pi_new = pi_star - h * jnp.einsum("j,j...->...", b.astype(x.dtype),
                                      dDiv, precision=_PREC)

    new = SpectralState(
        vort=prev.vort + dt2 * N.vort,
        div=div_new,
        T=T_new,
        lnps=pi_new,
        q=prev.q + dt2 * N.q,
        ql=prev.ql + dt2 * N.ql,
        qi=prev.qi + dt2 * N.qi,
        a=prev.a + dt2 * N.a,
    )
    return new


def hyperdiffuse(sht, s: SpectralState, dt, tau=3600.0 * 4,
                 damp_lnps=False):
    """Implicit del^4 damping; smallest resolved scale damped at rate 1/tau.

    damp_lnps: also damp the surface-pressure field. The Eulerian path
    computes lnps tendencies spectrally and needs no lnps diffusion
    (matching common practice), but the semi-Lagrangian path injects
    grid-scale interpolation noise into lnps every step; with no sink it
    accumulates until the hybrid pressure field destabilizes the run
    (observed in the HS94 T42 climatology: ps range drifting to
    920..1140 hPa by day 23, NaN later — round-3 FAIL)."""
    lam_max = sht.trunc * (sht.trunc + 1) / sht.radius ** 2
    nu = 1.0 / (tau * lam_max ** 2)
    fac = 1.0 / (1.0 + dt * nu * sht.laplacian ** 2)
    fac = fac[..., None]
    damp = lambda x: x * fac
    return SpectralState(vort=damp(s.vort), div=damp(s.div), T=damp(s.T),
                         lnps=damp(s.lnps) if damp_lnps else s.lnps,
                         q=damp(s.q), ql=damp(s.ql),
                         qi=damp(s.qi), a=damp(s.a))


def robert_filter(now, prev_f, new, eps=0.05):
    """Robert-Asselin filter: filtered 'now' for the next step."""
    f = lambda n, p, w: n + eps * (w - 2.0 * n + p)
    return SpectralState(*[f(n, p, w) for n, p, w in zip(now, prev_f, new)])

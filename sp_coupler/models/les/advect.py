"""Flux-form advection on the staggered C grid (anelastic, periodic x/y).

Provides the discrete operators the reference LES gets from DALES's
Fortran advection modules: 2nd-order central ("cd2", iadv=2) and
upwind-biased 5th / central 6th order horizontal with 2nd-order vertical
("hybrid52"/"hybrid62", iadv=52/62 — the schemes selected by the reference
case, /root/reference/dales-input/namoptions.001 &DYNAMICS).

All shifts are jnp.roll (periodic horizontally); vertical fluxes use
explicit zero boundary faces. Everything is elementwise + rolls, which
XLA fuses into a handful of memory passes.

Axis convention: [z, y, x] = axes (0, 1, 2) per instance.
"""

import jax.numpy as jnp

Z, Y, X = 0, 1, 2


def sp(a, ax, n=1):
    """a[i+n] at position i (periodic)."""
    return jnp.roll(a, -n, ax)


def sm(a, ax, n=1):
    """a[i-n] at position i (periodic)."""
    return jnp.roll(a, n, ax)


def face_cd2(s, ax):
    """2nd-order face value at face i (between cells i-1 and i)."""
    return 0.5 * (sm(s, ax) + s)


def face_up5(s, vel, ax):
    """5th-order upwind-biased face value at face i, advecting velocity vel."""
    s0, sp1, sp2 = s, sp(s, ax), sp(s, ax, 2)
    sm1, sm2, sm3 = sm(s, ax), sm(s, ax, 2), sm(s, ax, 3)
    central = (37.0 * (sm1 + s0) - 8.0 * (sm2 + sp1) + (sm3 + sp2)) / 60.0
    upwind = (10.0 * (s0 - sm1) - 5.0 * (sp1 - sm2) + (sp2 - sm3)) / 60.0
    return central - jnp.sign(vel) * upwind


def face_cd6(s, ax):
    """6th-order central face value at face i."""
    s0, sp1, sp2 = s, sp(s, ax), sp(s, ax, 2)
    sm1, sm2, sm3 = sm(s, ax), sm(s, ax, 2), sm(s, ax, 3)
    return (37.0 * (sm1 + s0) - 8.0 * (sm2 + sp1) + (sm3 + sp2)) / 60.0


def _hface(s, vel, ax, scheme):
    if scheme == "cd2":
        return face_cd2(s, ax)
    if scheme == "hybrid52":
        return face_up5(s, vel, ax)
    if scheme == "hybrid62":
        return face_cd6(s, ax)
    raise ValueError(f"unknown advection scheme {scheme}")


def advect_scalar(grid, rhobf, rhobh, u, v, w, s, scheme="hybrid52"):
    """Advection tendency of a cell-centered scalar, flux form.

    -(1/rho_f) div(rho u s); horizontal scheme selectable, vertical cd2.
    """
    # horizontal: rho_f cancels (constant per level)
    Fx = u * _hface(s, u, X, scheme)
    Fy = v * _hface(s, v, Y, scheme)
    tend = -(sp(Fx, X) - Fx) / grid.dx - (sp(Fy, Y) - Fy) / grid.dy
    # vertical, 2nd order, zero flux through bottom/top faces
    s_f = 0.5 * (s[1:] + s[:-1])                       # [nz-1] at interior faces
    Fz_int = rhobh[1:-1, None, None] * w[1:-1] * s_f
    zero = jnp.zeros_like(Fz_int[:1])
    Fz = jnp.concatenate([zero, Fz_int, zero], axis=Z)  # [nz+1]
    tend = tend - (Fz[1:] - Fz[:-1]) / (rhobf[:, None, None] * grid.dz)
    return tend


def advect_u(grid, rhobf, rhobh, u, v, w):
    """2nd-order advection tendency of u (x-face points)."""
    # x: flux at cell centers i: ((u_i + u_{i+1})/2)^2
    uc = 0.5 * (u + sp(u, X))
    Fx = uc * uc
    tx = -(Fx - sm(Fx, X)) / grid.dx
    # y: at corner (x-face i, y-face j): vbar * ubar
    vbar = 0.5 * (sm(v, X) + v)          # v interpolated to x-face column
    ubar = 0.5 * (sm(u, Y) + u)          # u interpolated to y-face row
    Fy = vbar * ubar
    ty = -(sp(Fy, Y) - Fy) / grid.dy
    # z: at (x-face i, z-face k)
    wbar = 0.5 * (sm(w, X) + w)          # [nz+1]
    u_zf = 0.5 * (u[1:] + u[:-1])        # [nz-1] interior z-faces
    Fz_int = rhobh[1:-1, None, None] * wbar[1:-1] * u_zf
    zero = jnp.zeros_like(Fz_int[:1])
    Fz = jnp.concatenate([zero, Fz_int, zero], axis=Z)
    tz = -(Fz[1:] - Fz[:-1]) / (rhobf[:, None, None] * grid.dz)
    return tx + ty + tz


def advect_v(grid, rhobf, rhobh, u, v, w):
    """2nd-order advection tendency of v (y-face points)."""
    vc = 0.5 * (v + sp(v, Y))
    Fy = vc * vc
    ty = -(Fy - sm(Fy, Y)) / grid.dy
    ubar = 0.5 * (sm(u, Y) + u)
    vbar = 0.5 * (sm(v, X) + v)
    Fx = ubar * vbar
    tx = -(sp(Fx, X) - Fx) / grid.dx
    wbar = 0.5 * (sm(w, Y) + w)
    v_zf = 0.5 * (v[1:] + v[:-1])
    Fz_int = rhobh[1:-1, None, None] * wbar[1:-1] * v_zf
    zero = jnp.zeros_like(Fz_int[:1])
    Fz = jnp.concatenate([zero, Fz_int, zero], axis=Z)
    tz = -(Fz[1:] - Fz[:-1]) / (rhobf[:, None, None] * grid.dz)
    return tx + ty + tz


def advect_w(grid, rhobf, rhobh, u, v, w):
    """2nd-order advection tendency of w at interior z-faces.

    Returns a full [nz+1, ny, nx] array with zero tendency on the
    boundary faces (w there stays 0).
    """
    wi = w[1:-1]                              # [nz-1] interior faces
    # x: u interpolated to z-face k: (u[k-1]+u[k])/2 for k=1..nz-1
    u_zf = 0.5 * (u[1:] + u[:-1])             # [nz-1] at x-faces
    Fx = u_zf * 0.5 * (sm(wi, X) + wi)
    tx = -(sp(Fx, X) - Fx) / grid.dx
    v_zf = 0.5 * (v[1:] + v[:-1])
    Fy = v_zf * 0.5 * (sm(wi, Y) + wi)
    ty = -(sp(Fy, Y) - Fy) / grid.dy
    # z: flux at cell centers k: rho_f * ((w[k]+w[k+1])/2)^2
    wc = 0.5 * (w[1:] + w[:-1])               # [nz] at centers
    Fz = rhobf[:, None, None] * wc * wc       # [nz]
    tz = -(Fz[1:] - Fz[:-1]) / (rhobh[1:-1, None, None] * grid.dz)
    tint = tx + ty + tz
    zero = jnp.zeros_like(w[:1])
    return jnp.concatenate([zero, tint, zero], axis=Z)


def divergence(grid, rhobf, rhobh, u, v, w):
    """div(rho u) at cell centers, [nz, ny, nx]."""
    du = (sp(u, X) - u) / grid.dx
    dv = (sp(v, Y) - v) / grid.dy
    Fw = rhobh[:, None, None] * w
    dw = (Fw[1:] - Fw[:-1]) / grid.dz
    return rhobf[:, None, None] * (du + dv) + dw

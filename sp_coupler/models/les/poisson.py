"""Anelastic pressure projection: all-matmul eigenbasis solve.

Enforces div(rho_b u) = 0 after each RK stage, the role of DALES's
FFT-based Poisson solver (consumed through the coupling surface of
/root/reference/splib/spcpl.py; DALES modpois).

Design. The periodic horizontal directions are diagonalized with a REAL
DFT expressed as dense matmuls (orthonormal cos/sin rows), not an FFT:
at LES plane sizes (64..128 per side) a dense [n,n] transform is a
small matmul with no complex arithmetic. The
vertical operator A = d/dz(rho_h d/dz) with Neumann BCs is a symmetric
tridiagonal; the generalized eigenproblem A v = mu D v, D = diag(rho_f),
is symmetrized to S = D^{-1/2} A D^{-1/2} and solved ONCE per evolve
call with jnp.linalg.eigh (the base density is fixed during a coupled
step), giving the solve

    phi = V (mu - lam)^{-1} V^T rhat,   V = D^{-1/2} U,

i.e. two more [nz, nz] matmuls per application. lam are the modified
horizontal wavenumbers, so the projected velocity is divergence-free for
the 2nd-order discrete divergence/gradient pair. One iterative
refinement pass (re-apply the 7-point operator, solve the residual)
brings the f32 residual below the sequential Thomas algorithm's: max
|div| after projection ~5e-6 * rho/dx vs ~1.2e-5 (64x64x160 case).

Why not scans: the Thomas implementation runs two 159-step lax.scans
over tiny [ny, nx/2] complex slices, a chain of sequential dependencies;
the eigenbasis solve is ~430 MFLOP of dense matmul with none. Which of
the two is faster on the H100 is not measured yet. The Thomas/rfft2
path is kept as `method="thomas"` for cross-checks.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .advect import divergence, X, Y, Z

# Full-f32 matmuls. A reduced-precision product (bf16 or TF32 inputs,
# which a GPU may use for a DEFAULT or HIGH f32 matmul) loses ~1e-3 and
# the operator's conditioning amplifies that into an unusable residual;
# chip_smoke.py reports the post-projection max|div| on the card.
_HI = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------------------
# real DFT basis (host-precomputed, cached per grid)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _real_dft_basis_np(n, d):
    """Orthonormal real Fourier basis F [n, n] and modified wavenumbers
    lam [n] such that F @ C @ F.T = diag(-lam) for the periodic 1-D
    second difference C/d^2. Rows: mean, (cos_k, sin_k) pairs, Nyquist.
    Returns NUMPY arrays — the cache must never hold traced values
    (inside shard_map even constants are tracers)."""
    x = np.arange(n)
    rows = [np.full(n, 1.0 / np.sqrt(n))]
    lam = [0.0]
    for k in range(1, (n + 1) // 2):
        rows.append(np.sqrt(2.0 / n) * np.cos(2 * np.pi * k * x / n))
        rows.append(np.sqrt(2.0 / n) * np.sin(2 * np.pi * k * x / n))
        l = (2.0 - 2.0 * np.cos(2 * np.pi * k / n)) / d ** 2
        lam += [l, l]
    if n % 2 == 0:
        rows.append(((-1.0) ** x) / np.sqrt(n))
        lam.append(4.0 / d ** 2)
    F = np.stack(rows).astype(np.float32)
    return F, np.asarray(lam, np.float32)


def _real_dft_basis(n, d):
    F, lam = _real_dft_basis_np(int(n), float(d))
    return jnp.asarray(F), jnp.asarray(lam)


class PoissonSolver(NamedTuple):
    """Factorized projection operator; build once per evolve call."""
    V: jax.Array      # [nz, nz] generalized eigenvectors (columns)
    inv: jax.Array    # [nz, ny, nx] 1/(mu - lam), mean mode zeroed
    Fy: jax.Array     # [ny, ny] real DFT basis
    Fx: jax.Array     # [nx, nx]


def build_solver(grid, rhobf, rhobh) -> PoissonSolver:
    """Eigen-factorize the anelastic pressure operator (in-jit, ~once
    per coupled step; amortized over hundreds of substeps)."""
    dz = grid.dz
    off = rhobh[1:-1] / dz ** 2                     # A[k, k+1] = A[k+1, k]
    dia = -(rhobh[:-1] + rhobh[1:]) / dz ** 2
    dia = dia.at[0].add(rhobh[0] / dz ** 2)         # Neumann: zero flux
    dia = dia.at[-1].add(rhobh[-1] / dz ** 2)       # through outer faces
    isq = 1.0 / jnp.sqrt(rhobf)
    S = (jnp.diag(dia * isq ** 2)
         + jnp.diag(off * isq[:-1] * isq[1:], 1)
         + jnp.diag(off * isq[:-1] * isq[1:], -1))
    mu, U = jnp.linalg.eigh(S)                      # ascending; mu[-1] ~ 0
    V = isq[:, None] * U
    Fx, lamx = _real_dft_basis(grid.nx, grid.dx)
    Fy, lamy = _real_dft_basis(grid.ny, grid.dy)
    lam = lamy[:, None] + lamx[None, :]             # [ny, nx]
    den = mu[:, None, None] - lam[None]
    inv = jnp.where(jnp.abs(den) < 1e-12, 0.0, 1.0 / den)
    inv = inv.at[-1, 0, 0].set(0.0)                 # pin the mean mode
    return PoissonSolver(V=V, inv=inv, Fy=Fy, Fx=Fx)


def _apply_operator(grid, rhobf, rhobh, phi):
    """The discrete operator: div(rho_b grad phi), Neumann in z."""
    rf = rhobf[:, None, None]
    lap_x = rf * (jnp.roll(phi, -1, X) - 2.0 * phi
                  + jnp.roll(phi, 1, X)) / grid.dx ** 2
    lap_y = rf * (jnp.roll(phi, -1, Y) - 2.0 * phi
                  + jnp.roll(phi, 1, Y)) / grid.dy ** 2
    # vertical flux rho_h dphi/dz at faces 1..nz-1, zero at outer faces
    Fz = rhobh[1:-1, None, None] * (phi[1:] - phi[:-1]) / grid.dz
    zero = jnp.zeros_like(phi[:1])
    Fz_lo = jnp.concatenate([zero, Fz], axis=Z)
    Fz_hi = jnp.concatenate([Fz, zero], axis=Z)
    return lap_x + lap_y + (Fz_hi - Fz_lo) / grid.dz


def _solve_once(solver: PoissonSolver, rhs):
    """phi = F_y^T V (mu-lam)^{-1} V^T (F_y rhs F_x^T) F_x — 6 matmuls."""
    rhat = jnp.einsum('ay,zyx->zax', solver.Fy, rhs, precision=_HI)
    rhat = jnp.einsum('bx,zax->zab', solver.Fx, rhat, precision=_HI)
    y = jnp.einsum('zi,zab->iab', solver.V, rhat, precision=_HI)
    y = y * solver.inv
    phat = jnp.einsum('zi,iab->zab', solver.V, y, precision=_HI)
    phi = jnp.einsum('ay,zab->zyb', solver.Fy, phat, precision=_HI)
    return jnp.einsum('bx,zyb->zyx', solver.Fx, phi, precision=_HI)


def solve_pressure(grid, rhobf, rhobh, rhs, solver=None, refine=1):
    """Solve div(rho_b grad phi) = rhs; Neumann top/bottom, periodic x/y.

    rhs at cell centers [nz, ny, nx]; returns phi at cell centers (mean
    mode zeroed — only gradients of phi are consumed). `refine` extra
    residual-correction passes polish f32 round-off.
    """
    if solver is None:
        solver = build_solver(grid, rhobf, rhobh)
    phi = _solve_once(solver, rhs)
    for _ in range(refine):
        r = rhs - _apply_operator(grid, rhobf, rhobh, phi)
        phi = phi + _solve_once(solver, r)
    return phi


# --------------------------------------------------------------------------
# reference Thomas/rfft2 path (sequential; for cross-checks off the hot path)
# --------------------------------------------------------------------------

def _modified_wavenumbers(grid, dtype=jnp.float32):
    kx = jnp.arange(grid.nx // 2 + 1)
    ky = jnp.arange(grid.ny)
    lx = (2.0 - 2.0 * jnp.cos(2.0 * jnp.pi * kx / grid.nx)) / grid.dx ** 2
    ly = (2.0 - 2.0 * jnp.cos(2.0 * jnp.pi * ky / grid.ny)) / grid.dy ** 2
    return (ly[:, None] + lx[None, :]).astype(dtype)


def solve_pressure_thomas(grid, rhobf, rhobh, rhs):
    """rfft2 + Thomas-sweep reference solver (two length-nz lax.scans)."""
    lam = _modified_wavenumbers(grid, rhs.dtype)              # [ny, nxh]
    rhat = jnp.fft.rfft2(rhs, axes=(Y, X))                    # [nz, ny, nxh]

    dz2 = grid.dz ** 2
    a = (rhobh[:-1] / dz2)                                    # [nz] sub-diag
    cc = (rhobh[1:] / dz2)                                    # [nz] super-diag
    a = a.at[0].set(0.0)
    cc = cc.at[-1].set(0.0)
    b = -(a + cc)[:, None, None] - rhobf[:, None, None] * lam[None]

    mean_mode = (lam == 0.0)[None]                            # [1, ny, nxh]
    b0 = jnp.where(mean_mode[0], 1.0, b[0])
    c0 = jnp.where(mean_mode[0], 0.0, cc[0])
    r0 = jnp.where(mean_mode[0], 0.0, rhat[0])

    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        ak, bk, ck, rk = inp
        denom = bk - ak * cp_prev
        cp = ck / denom
        dp = (rk - ak * dp_prev) / denom
        return (cp, dp), (cp, dp)

    b_rest = b[1:]
    c_rest = jnp.broadcast_to(cc[1:, None, None], b_rest.shape)
    a_rest = jnp.broadcast_to(a[1:, None, None], b_rest.shape)
    init_cp = c0 / b0
    init_dp = r0 / b0
    (_, _), (cps, dps) = jax.lax.scan(
        fwd, (init_cp, init_dp), (a_rest, b_rest, c_rest, rhat[1:]))
    cps = jnp.concatenate([init_cp[None], cps])
    dps = jnp.concatenate([init_dp[None], dps])

    def bwd(phi_next, inp):
        cp, dp = inp
        phi = dp - cp * phi_next
        return phi, phi

    _, phis = jax.lax.scan(bwd, dps[-1],
                           (cps[:-1][::-1], dps[:-1][::-1]))
    phat = jnp.concatenate([phis[::-1], dps[-1][None]])
    return jnp.fft.irfft2(phat, s=(grid.ny, grid.nx), axes=(Y, X))


# --------------------------------------------------------------------------
# projection
# --------------------------------------------------------------------------

def project(grid, rhobf, rhobh, u, v, w, dt, solver=None, method="eigen"):
    """Project (u, v, w) onto the divergence-free subspace.

    Returns corrected velocities and the pressure potential phi. Pass a
    prebuilt `solver` (build_solver) on the hot path so the eigh runs
    once per evolve, not per stage.
    """
    div = divergence(grid, rhobf, rhobh, u, v, w) / dt
    if method == "thomas":
        phi = solve_pressure_thomas(grid, rhobf, rhobh, div)
    else:
        phi = solve_pressure(grid, rhobf, rhobh, div, solver=solver)
    u = u - dt * (phi - jnp.roll(phi, 1, X)) / grid.dx
    v = v - dt * (phi - jnp.roll(phi, 1, Y)) / grid.dy
    dphidz = (phi[1:] - phi[:-1]) / grid.dz                    # interior faces
    zero = jnp.zeros_like(w[:1])
    w = w - dt * jnp.concatenate([zero, dphidz, zero], axis=Z)
    return u, v, w, phi

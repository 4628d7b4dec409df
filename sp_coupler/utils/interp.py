"""Vertical-grid interpolation and conservative remapping (pure JAX).

Reimplements the numerics of /root/reference/splib/sputils.py:82-197 in a
batched, jit-friendly form:

- ``interp``: linear interpolation with numpy.interp edge semantics
  (clamped to end values outside the range), vmap-able over columns.
- ``integral``: integral of a piecewise-constant function with optional
  density weights (sputils.py:94-161) — kept for tests/verification.
- ``conservative_matrix`` / ``interp_c``: the rho-weighted conservative
  coarse-graining (sputils.py:173-189) expressed as a precomputed overlap
  weight matrix applied with a matmul, the optimization the reference
  sketches at sputils.py:164-171. The matrix depends only on the two grids
  and the density profile, so one [nlev, nz] matmul replaces the reference's
  per-level Python integration loop and batches over columns.
"""

import jax
import jax.numpy as jnp

# f32 matvecs at full precision: a GPU's default f32 matmul may run in
# TF32 (about 3 decimal digits), far below what the coupled tendencies
# need; these remaps are tiny, so the full-precision pass costs nothing
PRECISION = jax.lax.Precision.HIGHEST


def matvec(W, q):
    """W @ q at PRECISION."""
    return jnp.matmul(W, q, precision=PRECISION)


def interp(x, xp, fp):
    """Linear interpolation, ascending xp, numpy.interp edge behavior."""
    return jnp.interp(x, xp, fp)


def interp_desc(x, xp_desc, fp_desc):
    """Linear interpolation where xp is in descending order.

    The reference reverses GCM arrays before calling numpy.interp
    (spcpl.py:224-228: ``interp(h, Zf[::-1], thl_[::-1])``); this helper does
    the reversal internally.
    """
    return jnp.interp(x, xp_desc[::-1], fp_desc[::-1])


def searchsorted(a, v, side="left"):
    return jnp.searchsorted(a, v, side=side)


def integral(a, b, z, q, w=None):
    """Integral over [a, b] of piecewise-constant q on ascending edges z.

    q[i] is the value on [z[i], z[i+1]]; len(z) == len(q) + 1. With weights w
    the result is the w-weighted mean of q over [a, b] (sputils.py:94-161).
    Jit-safe version using masks instead of index searches.
    """
    a, b = jnp.minimum(a, b), jnp.maximum(a, b)
    lo = jnp.maximum(z[:-1], a)
    hi = jnp.minimum(z[1:], b)
    overlap = jnp.maximum(hi - lo, 0.0)
    if w is None:
        return jnp.sum(q * overlap)
    return jnp.sum(w * q * overlap) / jnp.sum(w * overlap)


def overlap_lengths(Zh_desc, zh):
    """Overlap matrix between coarse cells (descending edges) and fine cells.

    Zh_desc: [nlev+1] GCM half-level heights in descending order (ends at 0).
    zh: [nz+1] LES half-level heights ascending from 0.
    Returns [nlev, nz] where entry (I, i) is the geometric overlap of GCM
    cell I (spanning [Zh_desc[I+1], Zh_desc[I]]) with LES cell i.
    """
    top = Zh_desc[:-1][:, None]    # [nlev, 1]
    bot = Zh_desc[1:][:, None]     # [nlev, 1]
    flo = zh[:-1][None, :]         # [1, nz]
    fhi = zh[1:][None, :]          # [1, nz]
    return jnp.maximum(jnp.minimum(top, fhi) - jnp.maximum(bot, flo), 0.0)


def conservative_matrix(Zh_desc, zh, rho):
    """Weight matrix W with (W @ q)[I] = rho-weighted mean of q in GCM cell I.

    Rows for GCM cells whose *top* is not strictly below the LES domain top
    are zeroed, matching the reference's ``if Zh[i] < zh[-1]`` guard
    (sputils.py:186-188): those coarse cells are (partly) outside the LES
    and contribute no remapped value.
    """
    ov = overlap_lengths(Zh_desc, zh)            # [nlev, nz]
    wrow = ov * rho[None, :]
    denom = jnp.sum(wrow, axis=1, keepdims=True)
    W = wrow / jnp.where(denom > 0, denom, 1.0)
    inside = (Zh_desc[:-1] < zh[-1])[:, None]
    return jnp.where(inside, W, 0.0)


def interp_c(Zh_desc, zh, q, rho):
    """Conservative coarse-graining of fine-grid q onto descending GCM cells.

    Equivalent to sputils.interp_c (sputils.py:173-189) but as one matvec.
    """
    return matvec(conservative_matrix(Zh_desc, zh, rho), q)


def interp_rho(Zh_desc, zh, rho):
    """Coarse-grid density: plain (unweighted) cell means (sputils.py:191-197)."""
    ov = overlap_lengths(Zh_desc, zh)
    num = matvec(ov, rho)
    cell = Zh_desc[:-1] - Zh_desc[1:]
    inside = Zh_desc[:-1] < zh[-1]
    return jnp.where(inside, num / jnp.where(cell > 0, cell, 1.0), 0.0)

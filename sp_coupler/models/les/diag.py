"""LES diagnostics: slab-mean profiles and cloud fraction on GCM levels.

Provides, as fused reductions inside the jitted program, everything the
reference coupler fetches from DALES per step via 14 async RPC getters
(get_les_profiles, /root/reference/splib/spcpl.py:747-767): U, V, presf,
Rhof, Rhobf, THL, QT, QL, QL_ice, QR, PS, T, A (cloud fraction mapped to
GCM levels) and accumulated Rain.
"""

import jax.numpy as jnp

from ...utils import interp as _interp
from . import step as _step
from .advect import sp, X, Y

QL_CLOUD_THRESHOLD = 1e-8  # kg/kg; a cell with more condensate is "cloudy"


def slab_profiles(grid, state):
    """Dict of [nz] slab-mean profiles + scalars, one LES instance."""
    from ... import constants as c
    T, ql, qs, thv = _step.thermodynamics(state)
    mean = lambda f: jnp.mean(f, axis=(Y, X))
    uc = 0.5 * (state.u + sp(state.u, X))
    vc = 0.5 * (state.v + sp(state.v, Y))
    ql_water, ql_ice = _ice_split_mean(T, ql)
    # actual vs base density: the reference fetches BOTH get_rhof (the
    # instantaneous slab density) and get_rhobf (the anelastic base state)
    # (spcpl.py:750-752). rhof from the ideal-gas law on the current
    # thermodynamic state at base pressure.
    Tv = T * (1.0 + (c.rv / c.rd - 1.0) * (state.qt - ql) - ql)
    rhof = mean(state.pbf[:, None, None] / (c.rd * Tv))
    return {
        "U": mean(uc),
        "V": mean(vc),
        "THL": mean(state.thl),
        "QT": mean(state.qt),
        "QL": mean(ql),
        "QL_ice": ql_ice,
        "QL_water": ql_water,
        "QR": mean(state.qr),
        "T": mean(T),
        "presf": state.pbf,
        "Rhof": rhof,
        "Rhobf": state.rhobf,
        "PS": state.ps,
        "Rain": state.rain,
        "cloudfrac_z": jnp.mean((ql > QL_CLOUD_THRESHOLD).astype(state.qt.dtype),
                                axis=(Y, X)),
        "qt_std": jnp.std(state.qt, axis=(Y, X)),
    }


def _ice_split_mean(T, ql):
    from . import micro
    ql_w, ql_i = micro.ice_split(T, ql)
    m = lambda f: jnp.mean(f, axis=(Y, X))
    return m(ql_w), m(ql_i)


def cloud_fraction_on_gcm_levels(grid, cloudfrac_z, gcm_Zh_desc):
    """Map per-LES-level cloud fraction onto GCM layers.

    The reference maps GCM half levels into LES level indices with
    searchsorted and asks DALES for per-slab fractions
    (get_cloud_fraction, spcpl.py:22-29). Here the mapping is a geometric
    overlap average: A[I] = thickness-weighted mean cloud fraction of the
    LES levels inside GCM layer I; layers above the LES top get 0. Output
    order matches gcm layers top-first (descending Zh), like the reference
    after its final reversal.
    """
    zh = jnp.arange(grid.nz + 1, dtype=cloudfrac_z.dtype) * grid.dz
    W = _interp.conservative_matrix(gcm_Zh_desc, zh, jnp.ones(grid.nz,
                                                              cloudfrac_z.dtype))
    return _interp.matvec(W, cloudfrac_z)


def fields_3d(state):
    """3-D diagnostic fields for the variability nudge (get_field access,
    spcpl.py:627-636)."""
    T, ql, qs, thv = _step.thermodynamics(state)
    return {"QT": state.qt, "THL": state.thl, "QL": ql, "Qsat": qs, "T": T}

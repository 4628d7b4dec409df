"""Coupling conversions: GCM columns <-> LES forcings/tendencies.

Batched, jit/vmap-safe re-implementation of the reference coupling physics
(/root/reference/splib/spcpl.py):

- convert_profiles (spcpl.py:171-246): GCM (U,V,T,SH,QL,QI,P,Zg) -> LES
  (u,v,thl,qt,ps,ql) on the LES vertical grid
- convert_surface_fluxes (spcpl.py:136-167): OpenIFS fluxes (positive down)
  -> DALES kinematic surface fluxes (positive up)
- les_forcings (spcpl.py:299-347): relaxation tendencies toward the GCM state
- gcm_tendencies (spcpl.py:388-542): LES slab means remapped (linear or
  conservative) to GCM levels, converted to GCM tendencies with vapor-only
  f_SH, liquid/ice split, and zeroing above the LES domain top

Every function operates on one column; batch over columns with jax.vmap.
All profiles follow the GCM's top-first level ordering (index 0 = model
top), as in OpenIFS.
"""

from typing import NamedTuple

import jax.numpy as jnp

from .. import constants as c
from ..utils import thermo, interp


class ConvertedProfiles(NamedTuple):
    """GCM column state converted to the LES grid + diagnostics."""

    u: jnp.ndarray       # [nz_les]
    v: jnp.ndarray
    thl: jnp.ndarray
    qt: jnp.ndarray
    ql: jnp.ndarray
    ps: jnp.ndarray      # []
    Zf: jnp.ndarray      # [L] GCM full-level heights (m), descending
    Zh: jnp.ndarray      # [L+1] GCM half-level heights (m), descending to 0
    Tv: jnp.ndarray      # [L]
    THL: jnp.ndarray     # [L] thl on GCM levels
    QT: jnp.ndarray      # [L] qt on GCM levels


def convert_profiles(prof, zf_les):
    """GCM profile dict (one column, [L] arrays) -> ConvertedProfiles.

    prof keys: U, V, T, SH, QL, QI, Pfull, Phalf, Zgfull, Zghalf
    (A unused here). Mirrors spcpl.convert_profiles math exactly:
    heights from geopotential relative to the surface (spcpl.py:197-198),
    thl with iexner on both terms (spcpl.py:214), numpy.interp edge
    semantics via jnp.interp.
    """
    U, V, T = prof["U"], prof["V"], prof["T"]
    SH, QL, QI = prof["SH"], prof["QL"], prof["QI"]
    Pf, Ph = prof["Pfull"], prof["Phalf"]
    Zgf, Zgh = prof["Zgfull"], prof["Zghalf"]

    Tv = thermo.virtual_temperature(T, SH, QL + QI)
    Zh = (Zgh - Zgh[-1]) / c.grav
    Zf = (Zgf - Zgh[-1]) / c.grav

    thl_ = thermo.thl_from_T(T, Pf, QL + QI)
    qt_ = SH + QL + QI

    itp = lambda fp: interp.interp_desc(zf_les, Zf, fp)
    return ConvertedProfiles(
        u=itp(U), v=itp(V), thl=itp(thl_), qt=itp(qt_), ql=itp(QL),
        ps=Ph[-1], Zf=Zf, Zh=Zh, Tv=Tv, THL=thl_, QT=qt_,
    )


def convert_surface_fluxes(surf, Ph_sfc, T_sfc):
    """OpenIFS surface fields -> (z0m, z0h, wthl, wqt) for the LES.

    surf keys: Z0M, Z0H, QLflux, QIflux, SHflux, TLflux, TSflux.
    Signs flip: OpenIFS positive down, DALES positive up
    (spcpl.py:153-167). wthl uses SENSIBLE heat only (TSflux).
    """
    rho = Ph_sfc / (c.rd * T_sfc)
    wqt = -(surf["QLflux"] + surf["QIflux"] + surf["SHflux"]) / rho
    wthl = -surf["TSflux"] * thermo.iexner(Ph_sfc) / (c.cp * rho)
    return surf["Z0M"], surf["Z0H"], wthl, wqt


def les_forcings(conv: ConvertedProfiles, les_prof, dt_gcm, factor=1.0):
    """Relaxation forcings on one LES instance (spcpl.py:328-333).

    les_prof: dict of LES slab means (keys U, V, THL, QT, QL, PS).
    Returns dict of f_u, f_v, f_thl, f_qt, f_ql ([nz]) and f_ps ([]).
    """
    f = lambda target, mean: factor * (target - mean) / dt_gcm
    return {
        "f_u": f(conv.u, les_prof["U"]),
        "f_v": f(conv.v, les_prof["V"]),
        "f_thl": f(conv.thl, les_prof["THL"]),
        "f_qt": f(conv.qt, les_prof["QT"]),
        "f_ql": f(conv.ql, les_prof["QL"]),
        "f_ps": f(conv.ps, les_prof["PS"]),
    }


def gcm_tendencies(prof, conv: ConvertedProfiles, les_prof, A_d,
                   zf_les, zh_les, dt_gcm, factor=1.0, conservative=False):
    """LES slab means -> GCM profile tendencies (spcpl.py:388-542).

    prof: GCM profile dict (top-first [L] arrays); conv: output of
    convert_profiles for the same column; les_prof: LES slab means;
    A_d: LES cloud fraction already mapped onto GCM layers [L].
    Returns (tend dict for U,V,T,SH,QL,QI,A, diagnostics dict).
    """
    Zf, Zh = conv.Zf, conv.Zh
    h = zf_les
    # real temperature from LES thl and GCM pressures (spcpl.py:408-409)
    pf = interp.interp_desc(h, Zf, prof["Pfull"])
    t_from_thl = les_prof["THL"] * thermo.exner(pf) + \
        c.rlv * les_prof["QL"] / c.cp
    t_d = les_prof["T"]
    ql_d = les_prof["QL"]
    ql_ice_d = les_prof["QL_ice"]
    ql_water_d = ql_d - ql_ice_d
    qt_d = les_prof["QT"]
    u_d, v_d = les_prof["U"], les_prof["V"]

    if not conservative:
        remap = lambda x: jnp.interp(Zf, h, x)
    else:
        W = interp.conservative_matrix(Zh, zh_les, les_prof["Rhobf"])
        remap = lambda x: interp.matvec(W, x)

    t_r = remap(t_d)
    qt_r = remap(qt_d)
    ql_r = remap(ql_d)
    ql_w_r = remap(ql_water_d)
    ql_i_r = remap(ql_ice_d)
    u_r = remap(u_d)
    v_r = remap(v_d)

    ft = dt_gcm
    f_T = factor * (t_r - prof["T"]) / ft
    # vapor only: subtract the condensate from qt (spcpl.py:502)
    f_SH = factor * ((qt_r - ql_r) - prof["SH"]) / ft
    f_QL = factor * (ql_w_r - prof["QL"]) / ft
    f_QI = factor * (ql_i_r - prof["QI"]) / ft
    f_U = factor * (u_r - prof["U"]) / ft
    f_V = factor * (v_r - prof["V"]) / ft
    f_A = factor * (A_d - prof["A"]) / ft

    # zero forcings on GCM levels above the LES domain top (spcpl.py:511-533)
    inside = (Zf <= h[-1]).astype(f_T.dtype)
    tend = {
        "T": f_T * inside, "SH": f_SH * inside, "QL": f_QL * inside,
        "QI": f_QI * inside, "U": f_U * inside, "V": f_V * inside,
        "A": f_A * inside,
    }
    diag = {
        "t": t_from_thl, "t_": t_d, "pf": pf,
        "ql_water": ql_water_d, "ql_ice": ql_ice_d,
    }
    return tend, diag

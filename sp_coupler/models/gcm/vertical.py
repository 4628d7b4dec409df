"""Vertical discretization: sigma/hybrid levels + semi-implicit matrices.

Simmons & Burridge (1981)-style energy-consistent vertical scheme on sigma
levels (hybrid A/B kept general in the half-level pressure definition;
the default level set is pure sigma). Precomputes:

- alpha_k, ln-ratio coefficients for hydrostatic integration and omega/p,
- G:  geopotential matrix, Phi' = Phi_s + G @ T        [L, L]
- W:  semi-implicit T-tendency coupling, dT/dt |= W @ D [L, L]
- b:  surface-pressure coupling, dlnps/dt |= -b @ D     [L]
- per-total-wavenumber implicit inverses (I - dt^2 lam_n (G W - R Tref 1 b^T))^-1

These play the role of OpenIFS's semi-implicit solver consumed through the
evolve_model_* phases (splib.py:186-188, 296-299, 335).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ... import constants as c

# full-f32 level couplings, as in dycore.py (no TF32 on the GPU)
_PREC = jax.lax.Precision.HIGHEST


def sigma_levels(nlev, stretch=1.7):
    """Half-level sigma values [nlev+1]: 0 at top -> 1 at surface."""
    k = np.arange(nlev + 1) / nlev
    return k ** stretch


def hybrid_ab(nlev, pref=1.0e5, stretch=1.7):
    """Hybrid sigma-pressure A/B half-level coefficients [nlev+1] each.

    p_{k+1/2} = A_k + B_k * ps, with B = sigma^2 (pure pressure at the
    top, terrain-following at the surface: B(0)=0, B(1)=1, dB/ds(0)=0)
    and A = pref * (sigma - sigma^2) so that AT THE REFERENCE SURFACE
    PRESSURE the level pressures coincide with the sigma set — the
    semi-implicit linearization (about ps=pref) is then identical to the
    sigma model's. OpenIFS runs on exactly this kind of hybrid level set
    (fort.4 / model defaults; SURVEY section 2.2)."""
    s = sigma_levels(nlev, stretch)
    B = s * s
    A = pref * (s - B)
    return A, B


class VerticalCoords:
    """Precomputed vertical-coordinate operators (numpy at init, jnp after).

    ``hybrid=True`` switches the half-level pressure definition from
    p = sigma * ps to p = A + B * ps. The semi-implicit matrices (G, W,
    b, implicit inverses) are always the REFERENCE-STATE (ps = pref)
    linearization; the nonlinear terms use per-column coefficients from
    `hybrid_coeffs`."""

    def __init__(self, nlev, tref=300.0, sigma_half=None, dtype=jnp.float32,
                 hybrid=False, pref=1.0e5, A_half=None, B_half=None):
        self.nlev = nlev
        self.tref = tref
        self.hybrid = bool(hybrid) or A_half is not None
        self.pref = pref
        sh = sigma_levels(nlev) if sigma_half is None else np.asarray(sigma_half)
        assert sh.shape == (nlev + 1,)
        if self.hybrid:
            if A_half is None:
                A_np, B_np = hybrid_ab(nlev, pref)
            else:
                A_np = np.asarray(A_half, np.float64)
                B_np = np.asarray(B_half, np.float64)
                sh = A_np / pref + B_np     # reference-state sigma
        else:
            A_np = np.zeros(nlev + 1)
            B_np = sh.astype(np.float64)
        self.A = jnp.asarray(A_np, dtype)
        self.B = jnp.asarray(B_np, dtype)
        self.dA = jnp.asarray(np.diff(A_np), dtype)
        self.dB = jnp.asarray(np.diff(B_np), dtype)
        ds = sh[1:] - sh[:-1]                       # [L]
        sf = 0.5 * (sh[1:] + sh[:-1])               # full levels (midpoints)
        # ln ratios; top layer (sigma=0 at top edge) uses the IFS convention
        lnr = np.zeros(nlev)
        lnr[1:] = np.log(sh[2:] / sh[1:-1])
        lnr[0] = 1.0 + np.log(2.0)                  # effective value, unused rows guard
        alpha = np.zeros(nlev)
        alpha[1:] = 1.0 - sh[1:-1] / ds[1:] * lnr[1:]
        alpha[0] = np.log(2.0)                      # IFS top-layer alpha
        # geopotential matrix: Phi_k = Phi_s + R [ sum_{j>k} T_j lnr_j + T_k alpha_k ]
        G = np.zeros((nlev, nlev))
        for k in range(nlev):
            G[k, k] = c.rd * alpha[k]
            for j in range(k + 1, nlev):
                G[k, j] = c.rd * lnr[j]
        # omega/p linear operator: (omega/p)_k = V.grad(lnps) - (Pmat @ C)_k
        # with C_j = D_j + V_j . grad(lnps):
        #   (Pmat @ C)_k = (1/ds_k)[ lnr_k sum_{j<k} C_j ds_j + alpha_k C_k ds_k ]
        Pm = np.zeros((nlev, nlev))
        for k in range(nlev):
            Pm[k, k] = alpha[k]
            for j in range(k):
                Pm[k, j] = lnr[k] * ds[j] / ds[k]
        Pm[0, 0] = alpha[0]
        # semi-implicit: dT/dt |= -kappa Tref (Pmat @ D)  => W = -kappa Tref Pm
        W = -c.kappa * tref * Pm
        b = ds.copy()                                # dlnps/dt = -sum ds_j C_j

        self.sh = jnp.asarray(sh, dtype)
        self.sf = jnp.asarray(sf, dtype)
        self.ds = jnp.asarray(ds, dtype)
        self.lnr = jnp.asarray(lnr, dtype)
        self.alpha = jnp.asarray(alpha, dtype)
        self.G = jnp.asarray(G, dtype)
        self.Pmat = jnp.asarray(Pm, dtype)
        self.W = jnp.asarray(W, dtype)
        self.b = jnp.asarray(b, dtype)
        self._G64, self._W64, self._b64 = G, W, b

    @functools.lru_cache(maxsize=4)
    def implicit_inverse(self, dt, trunc, radius=c.a_earth):
        """[(trunc+2,), L, L] inverse matrices for the semi-implicit solve.

        M_n = I - dt^2 lam_n (G W - R Tref 1 b^T), lam_n = n(n+1)/a^2.
        Returned as one stacked jnp array indexed by total wavenumber n.
        """
        L = self.nlev
        GW = self._G64 @ self._W64 - c.rd * self.tref * np.outer(
            np.ones(L), self._b64)
        ns = np.arange(trunc + 2)
        lam = ns * (ns + 1) / radius ** 2
        eye = np.eye(L)
        Ms = np.stack([np.linalg.inv(eye - dt * dt * l * GW) for l in lam])
        return jnp.asarray(Ms, jnp.float32)

    def pressures(self, ps):
        """Actual half/full-level pressures from surface pressure.

        ps: [...] -> (ph [L+1, ...], pf [L, ...]); level axis leading.
        Sigma mode: ph = sh * ps; hybrid: ph = A + B * ps."""
        shp = (self.nlev + 1,) + (1,) * jnp.ndim(ps)
        ph = self.A.reshape(shp) + self.B.reshape(shp) * ps[None]
        pf = 0.5 * (ph[1:] + ph[:-1])
        return ph, pf

    def hybrid_coeffs(self, ps):
        """Per-column nonlinear-term coefficients from actual pressures.

        Returns a dict with level axis leading, broadcast against ps:
          dpt  : Delta p_k / ps (per-unit-ps layer thickness)
          w    : ps dB_k / Delta p_k (surface-following weight of the
                 layer; == 1 in sigma coordinates)
          lnr  : ln(p_{k+1/2} / p_{k-1/2})  (top layer: IFS convention)
          alpha: 1 - p_{k-1/2}/Dp * lnr     (top layer: ln 2)
          Bh   : B at half levels [L+1, ...]
        In sigma mode these reduce exactly to the precomputed constants.
        """
        ph, pf = self.pressures(ps)
        dp = ph[1:] - ph[:-1]
        shp = (self.nlev,) + (1,) * jnp.ndim(ps)
        if not self.hybrid:
            one = jnp.ones_like(dp)
            return dict(dpt=self.ds.reshape(shp) * one, w=one,
                        lnr=self.lnr.reshape(shp) * one,
                        alpha=self.alpha.reshape(shp) * one,
                        Bh=self.B.reshape((self.nlev + 1,)
                                          + (1,) * jnp.ndim(ps))
                        * jnp.ones_like(ph), ph=ph, pf=pf)
        dpt = dp / ps[None]
        w = self.dB.reshape(shp) * ps[None] / dp
        safe_top = jnp.maximum(ph[:-1], 1e-3 * ph[1:])
        lnr = jnp.log(ph[1:] / safe_top)
        alpha = 1.0 - ph[:-1] / dp * lnr
        # IFS top-layer convention when the model top is p=0
        lnr = lnr.at[0].set(1.0 + jnp.log(2.0) * jnp.ones_like(lnr[0]))
        alpha = alpha.at[0].set(jnp.log(2.0) * jnp.ones_like(alpha[0]))
        Bh = (self.B.reshape((self.nlev + 1,) + (1,) * jnp.ndim(ps))
              * jnp.ones_like(ph))
        return dict(dpt=dpt, w=w, lnr=lnr, alpha=alpha, Bh=Bh, ph=ph,
                    pf=pf)

    def geopotential_half(self, T, phis=0.0, lnr=None):
        """Phi at half levels [..., L+1] from T [..., L] (top first).

        Phi_{k-1/2} = Phi_s + R sum_{j >= k} T_j lnr_j  (k = L..1);
        Phi at the bottom half level (surface) = Phi_s. Pass actual
        per-column `lnr` [..., L] on hybrid levels (defaults to the
        reference-state constants, exact on pure sigma)."""
        incr = c.rd * T * (self.lnr if lnr is None else lnr)   # [..., L]
        csum = jnp.cumsum(incr[..., ::-1], axis=-1)[..., ::-1]
        phih = jnp.concatenate([csum, jnp.zeros_like(csum[..., :1])], axis=-1)
        return phis + phih

    def geopotential_full(self, T, phis=0.0, lnr=None, alpha=None):
        """Phi at full levels [..., L] (top first).

        With actual hybrid coefficients: Phi_k = Phi_{k+1/2} + R alpha_k
        T_k (equivalent to the G-matrix form on pure sigma)."""
        if lnr is None:
            return phis + jnp.einsum("kj,...j->...k", self.G, T,
                                     precision=_PREC)
        phih = self.geopotential_half(T, phis, lnr)
        return phih[..., 1:] + c.rd * alpha * T

"""Spherical-harmonic transform tests: roundtrips and operator identities."""

import numpy as np
import jax.numpy as jnp
import pytest

from sp_coupler.models.gcm import spharm


@pytest.fixture(scope="module")
def sht():
    return spharm.SpectralTransform(21)


def random_spectral(sht, key=0, amp=1.0):
    rng = np.random.default_rng(key)
    s = (rng.normal(size=(sht.M, sht.N)) +
         1j * rng.normal(size=(sht.M, sht.N))) * amp
    s[0] = s[0].real  # m=0 coefficients of a real field are real
    s[:, -1] = 0.0    # keep the workspace row empty
    return sht.pack(jnp.asarray(s * np.asarray(sht.mask), jnp.complex64))


class TestTransforms:
    def test_orthonormality(self, sht):
        from sp_coupler.models.gcm.spharm import legendre_tables
        P, _ = legendre_tables(sht.trunc, sht.nlat)
        w = np.asarray(sht.w, np.float64)
        for m in (0, 1, 7, 21):
            G = np.einsum("j,jn,jk->nk", w, P[:, m, :], P[:, m, :])
            tri = slice(m, sht.trunc + 1)
            assert np.allclose(G[tri, tri], np.eye(G[tri, tri].shape[0]),
                               atol=2e-5), m

    def test_roundtrip_spectral(self, sht):
        s = random_spectral(sht)
        s2 = sht.analyze(sht.synthesize(s))
        assert np.allclose(np.asarray(s2), np.asarray(s), atol=1e-4)

    def test_roundtrip_smooth_grid(self, sht):
        lats = np.radians(sht.latitudes_deg())
        lons = np.radians(sht.longitudes_deg())
        f = (np.sin(2 * lons)[None, :] * np.cos(lats)[:, None] ** 2
             + np.sin(lats)[:, None] ** 3)
        f = jnp.asarray(f, jnp.float32)
        f2 = sht.synthesize(sht.analyze(f))
        assert np.allclose(np.asarray(f2), np.asarray(f), atol=1e-4)

    def test_mean_value(self, sht):
        f = jnp.full((sht.nlat, sht.nlon), 3.0)
        s = sht.analyze(f)
        # global mean = s[0,0,re] * P00 = s[0,0,0]/sqrt(2)
        assert np.isclose(float(s[0, 0, 0]) / np.sqrt(2), 3.0, rtol=1e-5)

    def test_batched(self, sht):
        s = jnp.stack([random_spectral(sht, k) for k in range(3)])
        g = sht.synthesize(s)
        assert g.shape == (3, sht.nlat, sht.nlon)
        s2 = sht.analyze(g)
        assert np.allclose(np.asarray(s2), np.asarray(s), atol=1e-4)


class TestOperators:
    def test_laplacian_eigenvalue(self, sht):
        s = sht.pack(jnp.zeros((sht.M, sht.N),
                               jnp.complex64).at[3, 5].set(1.0 + 0.5j))
        g = sht.synthesize(s)
        lap_g = sht.synthesize(s * sht.laplacian[..., None])
        want = -5 * 6 / sht.radius ** 2
        ratio = np.asarray(lap_g) / np.where(np.abs(np.asarray(g)) > 1e-8,
                                             np.asarray(g), 1.0)
        mask = np.abs(np.asarray(g)) > 1e-3 * np.abs(np.asarray(g)).max()
        assert np.allclose(ratio[mask], want, rtol=1e-3)

    def test_vort_div_roundtrip(self, sht):
        """u,v from (vort, div) -> analyzed back must match."""
        vort = random_spectral(sht, 1, amp=1e-5)
        div = random_spectral(sht, 2, amp=1e-5)
        # remove the n=0 / unresolved tail modes that uv cannot represent
        vort = vort.at[0, 0].set(0.0)
        div = div.at[0, 0].set(0.0)
        # zero the highest retained total wavenumber: the uv fields spill
        # one order beyond it and the quadrature then aliases
        trunc_mask = (np.asarray(sht.n) < sht.trunc).astype(
            np.float32)[..., None]
        vort = vort * trunc_mask
        div = div * trunc_mask
        u, v = sht.uv_from_vort_div(vort, div)
        vort2, div2 = sht.vort_div_from_uv(u, v)
        scale = float(jnp.max(jnp.abs(vort)))
        assert np.allclose(np.asarray(vort2 * trunc_mask),
                           np.asarray(vort), atol=3e-3 * scale)
        assert np.allclose(np.asarray(div2 * trunc_mask),
                           np.asarray(div), atol=3e-3 * scale)

    def test_solid_body_rotation_vorticity(self, sht):
        """u = U0 cos(lat) has vorticity 2 U0 mu / a and zero divergence."""
        U0 = 10.0
        u = jnp.broadcast_to(U0 * sht.cosl[:, None], (sht.nlat, sht.nlon))
        v = jnp.zeros_like(u)
        vort_s, div_s = sht.vort_div_from_uv(u, v)
        vort = sht.synthesize(vort_s)
        div = sht.synthesize(div_s)
        want = 2 * U0 * np.asarray(sht.mu)[:, None] / sht.radius
        assert np.allclose(np.asarray(vort), want, atol=1e-8)
        assert np.abs(np.asarray(div)).max() < 1e-8

    def test_gradient_of_zonal_harmonic(self, sht):
        """f = mu^2: df/dy = 2 mu cos(lat)/a, df/dx = 0."""
        f = jnp.broadcast_to((sht.mu ** 2)[:, None], (sht.nlat, sht.nlon))
        fs = sht.analyze(f)
        fx, fy = sht.grad(fs)
        mu = np.asarray(sht.mu)
        want_y = 2 * mu * np.sqrt(1 - mu ** 2) / sht.radius
        assert np.allclose(np.asarray(fy), want_y[:, None], atol=1e-9)
        assert np.abs(np.asarray(fx)).max() < 1e-10

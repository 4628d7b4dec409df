"""Coupling conversion math + variability nudge tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sp_coupler import constants as c
from sp_coupler.utils import thermo
from sp_coupler.coupling import convert, nudge


def synthetic_column(L=19):
    """IFS-like column, top-first ordering."""
    sf = np.exp(-4.0 * (np.arange(L)[::-1] + 0.5) / L)
    sh_lv = np.exp(-4.0 * np.arange(L + 1)[::-1] / L)
    ps = 1.0e5
    Pf = ps * sf
    Ph = ps * sh_lv
    T = 220.0 + 75.0 * sf ** 0.3
    SH = 0.016 * sf ** 2
    QL = np.where(sf > 0.8, 2e-4, 0.0)
    QI = np.where((sf > 0.3) & (sf < 0.5), 5e-5, 0.0)
    U = 10.0 * (1 - sf)
    V = -3.0 * np.ones(L)
    Zf = -c.rd * 280.0 / c.grav * np.log(sf)
    Zh = -c.rd * 280.0 / c.grav * np.log(np.maximum(sh_lv, 1e-10))
    Zh[0] = Zf[0] + 5000.0
    A = np.clip(QL * 1e3 + QI * 2e3, 0, 1)
    prof = {"U": U, "V": V, "T": T, "SH": SH, "QL": QL, "QI": QI,
            "Pfull": Pf, "Phalf": Ph, "A": A,
            "Zgfull": Zf * c.grav, "Zghalf": Zh * c.grav}
    return {k: jnp.asarray(v, jnp.float32) for k, v in prof.items()}


@pytest.fixture
def zf_les():
    return jnp.asarray((np.arange(160) + 0.5) * 25.0, jnp.float32)


@pytest.fixture
def zh_les():
    return jnp.asarray(np.arange(161) * 25.0, jnp.float32)


class TestConvertProfiles:
    def test_basic(self, zf_les):
        prof = synthetic_column()
        conv = convert.convert_profiles(prof, zf_les)
        # heights relative to the surface, descending
        assert float(conv.Zh[-1]) == 0.0
        assert np.all(np.diff(np.asarray(conv.Zf)) < 0)
        # qt on GCM levels = SH + QL + QI
        np.testing.assert_allclose(
            np.asarray(conv.QT),
            np.asarray(prof["SH"] + prof["QL"] + prof["QI"]), rtol=1e-6)
        # thl at the surface close to T/exner (no condensate at low level? QL>0)
        # verify thl formula at the top level (no condensate)
        thl_top = float(prof["T"][0] * thermo.iexner(prof["Pfull"][0]))
        assert np.isclose(float(conv.THL[0]), thl_top, rtol=1e-6)
        # interpolated fields are within GCM profile bounds
        assert np.asarray(conv.thl).min() >= float(jnp.min(conv.THL)) - 1e-3
        assert float(conv.ps) == pytest.approx(1.0e5, rel=1e-6)

    def test_interp_matches_reference_semantics(self, zf_les):
        """Linear interp with reversed arrays == numpy.interp reference."""
        prof = synthetic_column()
        conv = convert.convert_profiles(prof, zf_les)
        Zf = np.asarray(conv.Zf)
        thl_ = np.asarray(conv.THL)
        want = np.interp(np.asarray(zf_les), Zf[::-1], thl_[::-1])
        np.testing.assert_allclose(np.asarray(conv.thl), want, rtol=1e-5)

    def test_vmap_batching(self, zf_les):
        prof = synthetic_column()
        batch = {k: jnp.stack([v, v * 1.01]) for k, v in prof.items()}
        conv = jax.vmap(lambda p: convert.convert_profiles(p, zf_les))(batch)
        assert conv.u.shape == (2, 160)
        assert conv.Zh.shape == (2, 20)


class TestSurfaceFluxes:
    def test_sign_and_magnitude(self):
        surf = {"Z0M": jnp.float32(1e-4), "Z0H": jnp.float32(1e-5),
                "QLflux": jnp.float32(0.0), "QIflux": jnp.float32(0.0),
                "SHflux": jnp.float32(-5e-5),   # moisture up (IFS: negative)
                "TLflux": jnp.float32(-120.0),
                "TSflux": jnp.float32(-20.0)}   # sensible heat up
        z0m, z0h, wthl, wqt = convert.convert_surface_fluxes(
            surf, jnp.float32(1e5), jnp.float32(300.0))
        rho = 1e5 / (c.rd * 300.0)
        assert np.isclose(float(wqt), 5e-5 / rho, rtol=1e-5)
        want_wthl = 20.0 * thermo.iexner(1e5) / (c.cp * rho)
        assert np.isclose(float(wthl), float(want_wthl), rtol=1e-5)
        assert float(wthl) > 0 and float(wqt) > 0  # upward in LES convention


class TestForcings:
    def test_relaxation_formula(self, zf_les):
        prof = synthetic_column()
        conv = convert.convert_profiles(prof, zf_les)
        les_prof = {"U": conv.u - 1.0, "V": conv.v, "THL": conv.thl + 2.0,
                    "QT": conv.qt, "QL": conv.ql, "PS": conv.ps - 100.0}
        f = convert.les_forcings(conv, les_prof, dt_gcm=900.0, factor=1.0)
        np.testing.assert_allclose(np.asarray(f["f_u"]), 1.0 / 900.0,
                                   rtol=1e-4)
        np.testing.assert_allclose(np.asarray(f["f_thl"]), -2.0 / 900.0,
                                   rtol=1e-4)
        np.testing.assert_allclose(np.asarray(f["f_qt"]), 0.0, atol=1e-12)
        assert np.isclose(float(f["f_ps"]), 100.0 / 900.0)


class TestGCMTendencies:
    def _les_prof(self, zf):
        nz = len(zf)
        z = np.asarray(zf)
        prof = {
            "U": 8.0 * np.ones(nz), "V": -2.0 * np.ones(nz),
            "THL": 300.0 + 3e-3 * z, "QT": 0.016 * np.exp(-z / 2000.0),
            "QL": np.where((z > 600) & (z < 1500), 3e-4, 0.0),
            "QL_ice": np.where((z > 600) & (z < 1500), 3e-5, 0.0),
            "T": 298.0 - 6.5e-3 * z,
            "Rhobf": 1.2 * np.exp(-z / 8000.0),
        }
        return {k: jnp.asarray(v, jnp.float32) for k, v in prof.items()}

    def test_tendencies_zeroed_above_les_top(self, zf_les, zh_les):
        prof = synthetic_column()
        conv = convert.convert_profiles(prof, zf_les)
        les_prof = self._les_prof(zf_les)
        A_d = jnp.zeros(19)
        tend, diag = convert.gcm_tendencies(prof, conv, les_prof, A_d,
                                            zf_les, zh_les, 900.0)
        Zf = np.asarray(conv.Zf)
        top = float(zf_les[-1])
        above = Zf > top
        assert above.any() and (~above).any()
        for k in ("T", "SH", "QL", "QI", "U", "V", "A"):
            arr = np.asarray(tend[k])
            assert np.all(arr[above] == 0.0), k
            assert np.any(arr[~above] != 0.0), k

    def test_vapor_only_sh_tendency(self, zf_les, zh_les):
        """f_SH uses qt - ql (vapor), not qt (spcpl.py:502)."""
        prof = synthetic_column()
        conv = convert.convert_profiles(prof, zf_les)
        les_prof = self._les_prof(zf_les)
        tend, _ = convert.gcm_tendencies(prof, conv, les_prof, jnp.zeros(19),
                                         zf_les, zh_les, 900.0)
        # compute expected on the lowest GCM level (inside the LES domain)
        Zf = np.asarray(conv.Zf)
        qt_r = np.interp(Zf, np.asarray(zf_les), np.asarray(les_prof["QT"]))
        ql_r = np.interp(Zf, np.asarray(zf_les), np.asarray(les_prof["QL"]))
        want = (qt_r[-1] - ql_r[-1] - float(prof["SH"][-1])) / 900.0
        assert np.isclose(float(tend["SH"][-1]), want, rtol=1e-4)

    def test_conservative_vs_linear_close_for_smooth(self, zf_les, zh_les):
        prof = synthetic_column()
        conv = convert.convert_profiles(prof, zf_les)
        les_prof = self._les_prof(zf_les)
        t_lin, _ = convert.gcm_tendencies(prof, conv, les_prof, jnp.zeros(19),
                                          zf_les, zh_les, 900.0,
                                          conservative=False)
        t_con, _ = convert.gcm_tendencies(prof, conv, les_prof, jnp.zeros(19),
                                          zf_les, zh_les, 900.0,
                                          conservative=True)
        inside = np.asarray(conv.Zf) <= float(zf_les[-1])
        a = np.asarray(t_lin["U"])[inside]
        b = np.asarray(t_con["U"])[inside]
        np.testing.assert_allclose(a, b, atol=2e-4 * max(1e-9, np.abs(a).max()))


class TestVariabilityNudge:
    def _setup(self, nz=12, ny=16, nx=16, seed=0):
        rng = np.random.default_rng(seed)
        qt = 0.01 + 0.001 * rng.standard_normal((nz, ny, nx))
        thl = 290.0 + np.zeros((nz, ny, nx))
        qsat = np.full((nz, ny, nx), 0.012)
        p = np.full(nz, 9e4)
        return (jnp.asarray(qt, jnp.float32), jnp.asarray(thl, jnp.float32),
                jnp.asarray(qsat, jnp.float32), jnp.asarray(p, jnp.float32))

    def test_multiplicative_hits_target(self):
        qt, thl, qsat, p = self._setup()
        ql_ref = jnp.full(12, 2e-4, jnp.float32)
        res = nudge.variability_nudge(qt, thl, qsat, ql_ref, p,
                                      jax.random.PRNGKey(0), 900.0)
        ql_new = np.maximum(np.asarray(res.qt) - np.asarray(qsat), 0.0)
        got = ql_new.mean(axis=(1, 2))
        np.testing.assert_allclose(got, 2e-4, rtol=0.02)
        assert np.all(np.asarray(res.beta) > 1.0)  # had to amplify

    def test_no_nudge_when_both_clear(self):
        qt, thl, qsat, p = self._setup()
        qsat = qsat + 0.004  # 6 sigma above the mean: truly cloud-free LES
        ql_ref = jnp.zeros(12, jnp.float32)
        res = nudge.variability_nudge(qt, thl, qsat, ql_ref, p,
                                      jax.random.PRNGKey(0), 900.0)
        np.testing.assert_allclose(np.asarray(res.beta), 1.0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(res.qt), np.asarray(qt),
                                   atol=1e-8)

    def test_clear_sky_nudge_when_les_cloudy(self):
        qt, thl, qsat, p = self._setup()
        qt = qt + 0.0015  # mean stays subsaturated; tail cells saturate
        ql_ref = jnp.zeros(12, jnp.float32)
        res = nudge.variability_nudge(qt, thl, qsat, ql_ref, p,
                                      jax.random.PRNGKey(0), 900.0)
        ql_new = np.maximum(np.asarray(res.qt) - np.asarray(qsat), 0.0)
        # nudged toward barely unsaturated: residual cloud tiny
        assert ql_new.mean() < 1e-5
        assert np.all(np.asarray(res.beta) <= 1.0 + 1e-6)

    def test_additive_fallback(self):
        """Tiny variability + large ql_ref forces the additive branch."""
        nz, ny, nx = 6, 16, 16
        qt = jnp.full((nz, ny, nx), 0.010, jnp.float32)  # zero variance
        thl = jnp.full((nz, ny, nx), 290.0, jnp.float32)
        qsat = jnp.full((nz, ny, nx), 0.011, jnp.float32)
        p = jnp.full(nz, 9e4, jnp.float32)
        ql_ref = jnp.full(nz, 5e-4, jnp.float32)
        res = nudge.variability_nudge(qt, thl, qsat, ql_ref, p,
                                      jax.random.PRNGKey(3), 900.0)
        np.testing.assert_allclose(np.asarray(res.beta), 1.0, atol=1e-6)
        ql_new = np.maximum(np.asarray(res.qt) - np.asarray(qsat), 0.0)
        np.testing.assert_allclose(ql_new.mean(axis=(1, 2)), 5e-4, rtol=0.05)

    def test_constant_T_compensates_thl(self):
        qt, thl, qsat, p = self._setup()
        ql_ref = jnp.full(12, 3e-4, jnp.float32)
        res = nudge.variability_nudge(qt, thl, qsat, ql_ref, p,
                                      jax.random.PRNGKey(1), 900.0,
                                      constant_T=True)
        dql = (np.maximum(np.asarray(res.qt) - np.asarray(qsat), 0)
               - np.maximum(np.asarray(qt) - np.asarray(qsat), 0))
        dthl = np.asarray(res.thl) - np.asarray(thl)
        mask = np.abs(dql) > 1e-6  # avoid f32 round-off on tiny increments
        ratio = dthl[mask] / dql[mask]
        want = -c.rlv / (c.cp * float(thermo.exner(9e4)))
        np.testing.assert_allclose(ratio, want, rtol=1e-2)

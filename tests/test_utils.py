"""Unit tests for the numerics utilities.

Mirrors the reference's unit-test tier (splib/test/sputils_test.py) and adds
coverage for the conservative remap and saturation adjustment.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from sp_coupler import constants as c
from sp_coupler.utils import thermo, interp, geometry


class TestThermo:
    def test_rms(self):
        # reference cases: sputils_test.py
        assert np.isclose(float(thermo.rms(jnp.array([3.0, 4.0]))),
                          np.sqrt(12.5), atol=1e-6)
        assert np.isclose(float(thermo.rms(jnp.ones(10))), 1.0, atol=1e-6)

    def test_exner_identities(self):
        p = jnp.array([1e5, 8e4, 5e4, 1e4])
        ex = thermo.exner(p)
        iex = thermo.iexner(p)
        assert np.allclose(np.asarray(ex * iex), 1.0, atol=1e-6)
        assert np.isclose(float(thermo.exner(jnp.array(c.pref0))), 1.0, atol=1e-7)

    def test_virtual_temperature(self):
        T = 290.0
        tv = float(thermo.virtual_temperature(jnp.array(T), 0.01, 0.001))
        assert np.isclose(tv, T * (1 + (c.rv / c.rd - 1) * 0.01 - 0.001), rtol=1e-6)

    def test_thl_roundtrip(self):
        p = jnp.array(9e4)
        T = jnp.array(285.0)
        ql = jnp.array(1e-4)
        thl = thermo.thl_from_T(T, p, ql)
        T2 = thermo.T_from_thl(thl, p, ql)
        assert np.isclose(float(T2), float(T), atol=1e-3)

    def test_qsat_monotone_in_T(self):
        p = 9e4
        q1 = float(thermo.qsat_liq(jnp.array(280.0), p))
        q2 = float(thermo.qsat_liq(jnp.array(290.0), p))
        assert 0 < q1 < q2 < 0.1

    def test_sat_adjust_subsaturated(self):
        p = jnp.array(1.0e5)
        thl = jnp.array(290.0)
        qt = jnp.array(1e-3)  # dry
        T, ql, qs = thermo.sat_adjust(thl, qt, p)
        assert float(ql) == 0.0
        assert np.isclose(float(T), float(thl * thermo.exner(p)), atol=1e-4)

    def test_sat_adjust_saturated_consistency(self):
        p = jnp.array(9.0e4)
        thl = jnp.array(285.0)
        qt = jnp.array(0.02)  # very moist -> must condense
        T, ql, qs = thermo.sat_adjust(thl, qt, p, n_iter=6)
        assert float(ql) > 0
        # T consistent with thl/ql relation
        assert np.isclose(float(T), float(thermo.T_from_thl(thl, p, ql)), atol=1e-3)
        # residual vapor ~ saturation
        assert np.isclose(float(qt - ql), float(qs), rtol=2e-3)


class TestInterp:
    def test_linear_matches_numpy(self):
        xp = jnp.array([0.0, 1.0, 3.0, 6.0])
        fp = jnp.array([1.0, 2.0, 0.0, 3.0])
        x = jnp.array([-1.0, 0.5, 2.0, 7.0])
        got = np.asarray(interp.interp(x, xp, fp))
        want = np.interp(np.asarray(x), np.asarray(xp), np.asarray(fp))
        assert np.allclose(got, want)

    def test_interp_desc(self):
        zf_desc = jnp.array([3000.0, 2000.0, 1000.0, 0.0])
        prof_desc = jnp.array([3.0, 2.0, 1.0, 0.0])
        got = interp.interp_desc(jnp.array([500.0, 1500.0]), zf_desc, prof_desc)
        assert np.allclose(np.asarray(got), [0.5, 1.5])

    def test_integral_plain(self):
        z = jnp.array([0.0, 1.0, 2.0, 4.0])
        q = jnp.array([1.0, 2.0, 3.0])
        # full range: 1 + 2 + 6 = 9
        assert np.isclose(float(interp.integral(0.0, 4.0, z, q)), 9.0)
        # partial cells: [0.5, 2.5] -> 0.5*1 + 1*2 + 0.5*3 = 4.0
        assert np.isclose(float(interp.integral(0.5, 2.5, z, q)), 4.0)

    def test_integral_weighted_is_mean(self):
        z = jnp.array([0.0, 1.0, 2.0])
        q = jnp.array([2.0, 4.0])
        w = jnp.array([1.0, 3.0])
        want = (2.0 * 1.0 + 4.0 * 3.0) / 4.0
        assert np.isclose(float(interp.integral(0.0, 2.0, z, q, w)), want)

    def test_conservative_matrix_conserves_mass(self):
        """rho-weighted integral of the remapped profile equals the fine one."""
        nz = 40
        zh = jnp.linspace(0.0, 4000.0, nz + 1)
        rho = jnp.exp(-0.5 * (zh[:-1] + zh[1:]) / 2.0 / 8000.0)
        rng = np.random.default_rng(0)
        q = jnp.asarray(rng.uniform(0.0, 1.0, nz))
        # coarse edges, descending, all inside the LES domain
        Zh = jnp.array([3800.0, 3000.0, 1700.0, 800.0, 0.0])
        Q = interp.interp_c(Zh, zh, q, rho)
        # check each coarse cell against the reference-style integral
        for i in range(len(Zh) - 1):
            want = float(interp.integral(float(Zh[i + 1]), float(Zh[i]), zh, q, rho))
            assert np.isclose(float(Q[i]), want, rtol=1e-5), i

    def test_conservative_matrix_zero_above_top(self):
        zh = jnp.linspace(0.0, 4000.0, 11)
        rho = jnp.ones(10)
        q = jnp.ones(10)
        Zh = jnp.array([9000.0, 5000.0, 3000.0, 0.0])  # top 2 cells reach above
        Q = interp.interp_c(Zh, zh, q, rho)
        assert float(Q[0]) == 0.0  # cell 9000-5000: outside
        assert float(Q[1]) == 0.0  # cell 5000-3000: top edge above les top
        assert np.isclose(float(Q[2]), 1.0)

    def test_constant_preserved(self):
        zh = jnp.linspace(0.0, 4000.0, 161)
        rho = jnp.exp(-jnp.linspace(0, 0.5, 160))
        q = jnp.full(160, 7.0)
        Zh = jnp.array([3500.0, 2000.0, 500.0, 0.0])
        Q = interp.interp_c(Zh, zh, q, rho)
        assert np.allclose(np.asarray(Q), 7.0, rtol=1e-6)


class TestGeometry:
    def test_haversine_known(self):
        # quarter circumference: pole to equator
        d = geometry.haversine((0.0, 0.0), (0.0, 90.0))
        assert np.isclose(d, np.pi / 2 * geometry.EARTH_RADIUS_KM, rtol=1e-6)

    def test_closest_ordering(self):
        pts = [(0.0, 0.0), (10.0, 0.0), (20.0, 0.0), (30.0, 0.0)]
        order = geometry.find_closest_points(pts, (11.0, 0.0))
        assert list(order) == [1, 2, 0, 3]

    def test_polygon_contains(self):
        poly = geometry.Polygon([(0, 0), (10, 0), (10, 10), (0, 10)])
        assert poly.contains((5, 5))
        assert not poly.contains((15, 5))

    def test_mask_indices_single_point_nmax(self):
        pts = [(0.0, 0.0), (1.0, 0.0), (2.0, 0.0), (3.0, 0.0)]
        idx = geometry.get_mask_indices(pts, [geometry.Point((0.2, 0.0))], nmax=2)
        assert list(idx) == [0, 1]
        idx1 = geometry.get_mask_indices(pts, [geometry.Point((2.9, 0.0))])
        assert list(idx1) == [3]

    def test_mask_indices_polygon_both_lon_conventions(self):
        # grid point at lon=320 (=-40); polygon drawn in [-180,180]
        pts = [(320.0, 15.0), (100.0, 15.0)]
        poly = geometry.Polygon([(-50, 10), (-30, 10), (-30, 20), (-50, 20)])
        idx = geometry.get_mask_indices(pts, [poly])
        assert idx == [0]

    def test_parse_lat_lons(self):
        out = geometry.parse_lat_lons(["10", "-40", "20", "-50"])
        assert out == [(320.0, 10.0), (310.0, 20.0)]

    def test_mask_indices_nmax_zero(self):
        assert geometry.get_mask_indices([(0, 0)], [geometry.Point((0, 0))], 0) == []


class TestConfig:
    def test_read_config_dict(self):
        from sp_coupler.config import read_config, SPConfig
        cfg = read_config({"gcm_steps": 5, "unknown_key": 1, "les_itot": 32})
        assert cfg.gcm_steps == 5 and cfg.les_itot == 32
        assert isinstance(cfg, SPConfig)

    def test_read_config_json(self, tmp_path):
        from sp_coupler.config import read_config
        p = tmp_path / "conf.json"
        p.write_text('{"qt_forcing": "variance"}')
        cfg = read_config(str(p))
        assert cfg.qt_forcing == "variance"

"""Native CDF writer tests: format roundtrip, async queue, cross sections."""

import numpy as np
import pytest

from sp_coupler.io import spnc, crossio


def _roundtrip(writer_cls, path):
    w = writer_cls(str(path))
    t = w.def_dim("time", None)
    z = w.def_dim("z", 4)
    tv = w.def_var("time", "s", [t])
    pv = w.def_var("prof", "K", [t, z])
    sv = w.def_var("static", "m", [z])
    w.enddef()
    w.put(sv, 0, np.arange(4.0))
    for r in range(3):
        w.put(tv, r, np.asarray([r * 60.0], np.float32))
        w.put(pv, r, np.arange(4.0) + 10 * r)
    w.flush()
    w.close()
    data, units = spnc.read_cdf(str(path))
    np.testing.assert_allclose(np.asarray(data["static"]), np.arange(4.0))
    np.testing.assert_allclose(np.asarray(data["time"]).ravel(),
                               [0.0, 60.0, 120.0])
    np.testing.assert_allclose(np.asarray(data["prof"])[2],
                               np.arange(4.0) + 20.0)
    assert units["prof"] == "K"


class TestPythonWriter:
    def test_roundtrip(self, tmp_path):
        _roundtrip(spnc.PythonCDFWriter, tmp_path / "p.nc")


class TestNativeWriter:
    def test_native_builds(self):
        assert spnc._load_lib() is not None, "g++ build of libspnc failed"

    def test_roundtrip(self, tmp_path):
        if spnc._load_lib() is None:
            pytest.skip("native writer unavailable")
        _roundtrip(spnc.NativeCDFWriter, tmp_path / "n.nc")

    def test_async_many_records(self, tmp_path):
        if spnc._load_lib() is None:
            pytest.skip("native writer unavailable")
        w = spnc.NativeCDFWriter(str(tmp_path / "big.nc"))
        t = w.def_dim("time", None)
        y = w.def_dim("y", 32)
        x = w.def_dim("x", 32)
        v = w.def_var("f", "1", [t, y, x])
        w.enddef()
        for r in range(50):
            w.put(v, r, np.full((32, 32), float(r), np.float32))
        w.flush()
        assert w.queue_depth() == 0
        w.close()
        data, _ = spnc.read_cdf(str(tmp_path / "big.nc"))
        arr = np.asarray(data["f"])
        assert arr.shape == (50, 32, 32)
        np.testing.assert_allclose(arr[17], 17.0)
        np.testing.assert_allclose(arr[49], 49.0)

    def test_scipy_reads_it(self, tmp_path):
        """The produced file is a valid netCDF classic file."""
        if spnc._load_lib() is None:
            pytest.skip("native writer unavailable")
        from scipy.io import netcdf_file
        w = spnc.NativeCDFWriter(str(tmp_path / "s.nc"))
        t = w.def_dim("time", None)
        z = w.def_dim("z", 3)
        v = w.def_var("q", "kg/kg", [t, z])
        w.enddef()
        w.put(v, 0, np.asarray([1.0, 2.0, 3.0], np.float32))
        w.flush()
        w.close()
        f = netcdf_file(str(tmp_path / "s.nc"), "r", mmap=False)
        np.testing.assert_allclose(f.variables["q"][0], [1.0, 2.0, 3.0])
        assert f.variables["q"].units == b"kg/kg"
        f.close()


class TestCrossIO:
    def test_fleet_cross_sections(self, tmp_path):
        import jax
        from sp_coupler.models.les import grid as lgrid, state as lstate
        g = lgrid.LESGrid(nx=8, ny=8, nz=10, dx=100.0, dy=100.0, dz=100.0)
        prof = np.linspace(300.0, 310.0, 10).astype(np.float32)
        qt0 = np.full(10, 0.01, np.float32)
        keys = jax.vmap(jax.random.PRNGKey)(np.arange(2))
        state = jax.vmap(lambda k: lstate.init_state(
            g, prof * 0, prof * 0, prof, qt0, 1e5, k))(keys)
        io = crossio.FleetCrossIO(str(tmp_path), g, [11, 22], heights=(2, 5))
        ql = np.zeros((2, 10, 8, 8), np.float32)
        ql[:, 5] = 1e-4
        io.write(state, ql, 60.0)
        io.write(state, ql, 120.0)
        io.close()
        data, units = spnc.read_cdf(str(tmp_path / "les-work-11" / "cross.nc"))
        assert np.asarray(data["thlxy002"]).shape == (2, 8, 8)
        lwp = np.asarray(data["lwp"])
        assert lwp.shape == (2, 8, 8)
        # LWP = rho * ql * dz at the one cloudy level
        assert np.all(lwp > 0)
        np.testing.assert_allclose(np.asarray(data["time"]).ravel(),
                                   [60.0, 120.0])

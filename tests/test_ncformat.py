"""spifs.nc must be a valid netCDF classic (CDF-2) file for third-party tools.

Conformance is checked at the byte level (magic, header) and by reading
the file back with scipy.io.netcdf_file, an independent netCDF-3 reader.
Reference consumer story: /root/reference/examples/access-spifs-nc.py.
"""

import datetime

import numpy as np
import pytest
import scipy.io

from sp_coupler.io import nc3, spifs


def _write_sample(path):
    w = spifs.SpifsWriter(
        str(path), gcm_ktot=8,
        les_info={"x": np.arange(4) * 100.0 + 50.0,
                  "y": np.arange(4) * 100.0 + 50.0,
                  "zf": np.arange(6) * 25.0 + 12.5},
        start_time=datetime.datetime(2000, 1, 1))
    w.add_les_column(7, 13.0, -59.0)
    w.add_output_column(9, 14.0, -58.0)
    for s in range(3):
        w.update_time(900.0 * (s + 1))
        w.write_column(7, thl=np.full(6, 300.0 + s), U=np.full(8, 5.0),
                       rain=0.5 * s)
        w.write_column(9, U=np.full(8, 4.0))
    w.sync()
    w.close()


def test_netcdf_classic_conventions(tmp_path):
    path = tmp_path / "spifs.nc"
    _write_sample(path)
    assert path.read_bytes()[:4] == b"CDF\x02"   # 64-bit-offset format

    f = scipy.io.netcdf_file(str(path), "r", mmap=False)
    try:
        assert f.version_byte == 2
        assert f.dimensions["Time"] is None           # record dimension
        assert f.dimensions["column"] == 2
        assert f.dimensions["zf"] == 6
        assert f.dimensions["oifs_height"] == 8
        t = f.variables["Time"]
        assert t.shape == (3,)
        assert t.units.decode().startswith("s since 2000-01-01")
        np.testing.assert_array_equal(f.variables["column_index"][:],
                                      [7, 9])
        np.testing.assert_array_equal(f.variables["is_les"][:], [1, 0])
        np.testing.assert_allclose(f.variables["lat"][:], [13.0, 14.0])
        thl = f.variables["thl"]
        assert thl.dimensions == ("Time", "column", "zf")
        assert thl.units == b"K"
        np.testing.assert_allclose(thl[:, 0, 0], [300.0, 301.0, 302.0])
        # the output-only column's LES cells stay at the fill value
        assert np.isnan(thl[:, 1]).all()
        assert f.variables["U"].dimensions == ("Time", "column",
                                               "oifs_height")
        np.testing.assert_allclose(f.variables["rain"][:, 0],
                                   [0.0, 0.5, 1.0])
        np.testing.assert_allclose(f.variables["U"][:, 1, 0], 4.0)
    finally:
        f.close()


def test_append_preserves_conventions(tmp_path):
    path = tmp_path / "spifs.nc"
    _write_sample(path)
    w = spifs.SpifsWriter(str(path), gcm_ktot=8, append=True)
    w.update_time(3600.0)
    w.write_column(7, thl=np.full(6, 310.0))
    w.close()

    f = scipy.io.netcdf_file(str(path), "r", mmap=False)
    try:
        np.testing.assert_allclose(f.variables["Time"][:],
                                   [900.0, 1800.0, 2700.0, 3600.0])
        assert f.variables["thl"].shape == (4, 2, 6)
        assert float(f.variables["thl"][3, 0, 0]) == 310.0
        assert float(f.variables["thl"][2, 0, 0]) == 302.0
        assert float(f.variables["rain"][1, 0]) == 0.5
    finally:
        f.close()


def test_column_view_api(tmp_path):
    """open_reader keeps the reference's per-column group view."""
    path = tmp_path / "spifs.nc"
    _write_sample(path)
    ds = spifs.open_reader(str(path))
    try:
        assert sorted(ds.groups, key=int) == ["7", "9"]
        g = ds.groups["7"]
        assert g.variables["thl"].shape == (3, 6)
        assert len(g.variables["thl"]) == 3
        np.testing.assert_allclose(g.variables["thl"][1], 301.0)
        np.testing.assert_allclose(g.variables["rain"][:], [0, 0.5, 1.0])
        assert float(g.variables["lat"][()]) == 13.0
        assert float(ds.groups["9"].variables["lon"][()]) == -58.0
        assert g.variables["thl"].units == "K"
        assert g.variables["thl"][:].dtype == np.float32
        assert "thl" not in ds.groups["9"].variables
        assert "f_T" not in ds.groups["9"].variables
        assert ds.dimensions["oifs_height"] == 8
        np.testing.assert_allclose(ds.variables["Time"][:],
                                   [900.0, 1800.0, 2700.0])
    finally:
        ds.close()


def test_writes_to_unknown_targets_are_skipped(tmp_path):
    """Unknown variables and LES variables of output-only columns are
    logged and dropped (spio.write_les_data semantics)."""
    path = tmp_path / "spifs.nc"
    w = spifs.SpifsWriter(str(path), gcm_ktot=4,
                          les_info={"x": [0.0], "y": [0.0],
                                    "zf": [1.0, 2.0]})
    w.add_les_column(1, 0.0, 0.0)
    w.add_output_column(2, 1.0, 1.0)
    w.update_time(1.0)
    w.write_column(2, thl=np.ones(2), nosuchvar=1.0)
    w.write_column(3, U=np.ones(4))
    w.close()
    ds = spifs.open_reader(str(path))
    try:
        assert np.isnan(ds.variables["thl"][0]).all()
        assert sorted(ds.groups) == ["1", "2"]
    finally:
        ds.close()


def test_columns_fixed_after_first_record(tmp_path):
    w = spifs.SpifsWriter(str(tmp_path / "spifs.nc"), gcm_ktot=4)
    w.add_output_column(1, 0.0, 0.0)
    w.update_time(1.0)
    with pytest.raises(RuntimeError):
        w.add_output_column(2, 0.0, 0.0)
    w.close()


@pytest.mark.parametrize("dtype", ["f4", "f8", "i4", "i2", "i1"])
def test_nc3_types_roundtrip_through_scipy(tmp_path, dtype):
    path = str(tmp_path / "t.nc")
    ds = nc3.Dataset(path, "w")
    ds.createDimension("t", None)
    ds.createDimension("n", 3)
    ds.createVariable("fixed", dtype, ("n",), units="u")
    ds.createVariable("rec", dtype, ("t", "n"))
    ds.createVariable("other", "f4", ("t",))
    ds.enddef()
    ds.put("fixed", np.arange(3))
    for r in range(2):
        ds.put_record(r, {"rec": np.arange(3) + 10 * r, "other": r})
    ds.close()
    f = scipy.io.netcdf_file(path, "r", mmap=False)
    try:
        np.testing.assert_array_equal(f.variables["fixed"][:], [0, 1, 2])
        np.testing.assert_array_equal(f.variables["rec"][:],
                                      [[0, 1, 2], [10, 11, 12]])
        np.testing.assert_array_equal(f.variables["other"][:], [0, 1])
    finally:
        f.close()
    r = nc3.Dataset(path, "r")
    assert r.variables["rec"][1].tolist() == [10, 11, 12]
    assert r.variables["fixed"].units == "u"
    r.close()

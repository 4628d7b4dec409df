"""Golden-run regression: replay the recorded BASELINE config-2 spifs.nc.

tests/golden/spifs.nc is an accelerator recording (golden_meta.json names
the device) of T21 + 16 SP columns x 100 coupled steps
(scripts/make_golden.py), stored as netCDF classic. Both models are replayed from the
recording while the REAL coupling layer recomputes every conversion,
forcing, and tendency; the replay setters compare what the coupler sends
back against what was recorded. This is the reference's core offline
regression mechanism (/root/reference/splib/ncmod.py:167-170, 245-261)
pointed at a real checked-in golden run.

The comparison crosses platforms (accelerator recording, CPU CI): the coupling
math is [n, L] profile arithmetic, one step deep, so it reproduces to
float32 rounding (measured ~1e-11 absolute), far below the 1e-5-relative
gate here.
"""

import json
import os

import numpy as np
import pytest

from sp_coupler.config import SPConfig
from sp_coupler.io import spifs
from sp_coupler.runtime.driver import SPRunner
from sp_coupler.utils import geometry

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_NC = os.path.join(GOLDEN, "spifs.nc")

needs_golden = pytest.mark.skipif(
    not os.path.exists(GOLDEN_NC),
    reason="no golden recording (run scripts/make_golden.py)")


@needs_golden
class TestGoldenStructure:
    def test_recording_shape(self):
        ds = spifs.open_reader(GOLDEN_NC)
        try:
            groups = sorted(ds.groups, key=int)
            assert len(groups) == 16
            with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
                meta = json.load(f)
            assert meta["steps"] == 100
            nt = len(np.asarray(ds.variables["Time"][:]))
            assert nt >= meta["steps"]
            for g in groups:
                grp = ds.groups[g]
                for var in ("T", "f_T", "thl", "f_thl", "u", "Psurf"):
                    vals = np.asarray(grp.variables[var][:])
                    assert np.all(np.isfinite(vals)), (g, var)
                # a convecting LES column: actual density differs from base
                rhof = np.asarray(grp.variables["rhof"][-1])
                rhobf = np.asarray(grp.variables["rhobf"][-1])
                assert np.any(np.abs(rhof - rhobf) > 0)
        finally:
            ds.close()

    def test_meta_polygon_selects_recorded_columns(self):
        """The meta polygon must select EXACTLY the recorded grid columns.

        Guards against the meta drifting away from the artifact (a stale
        superset polygon once passed the replay silently)."""
        with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
            meta = json.load(f)
        from sp_coupler.models.gcm import spharm
        nlon, nlat = spharm.GRID_FOR_TRUNC[21]
        mu, _ = spharm.gaussian_latitudes(nlat)
        lats = np.degrees(np.arcsin(mu))
        lons = np.arange(nlon) * 360.0 / nlon
        points = [(lon, lat) for lat in lats for lon in lons]
        lat_lon = [float(v) for v in meta["poly_lat_lon"]]
        poly = geometry.Polygon(geometry.parse_lat_lons(lat_lon))
        sel = geometry.get_mask_indices(points, [poly])
        ds = spifs.open_reader(GOLDEN_NC)
        try:
            recorded = sorted(int(g) for g in ds.groups)
        finally:
            ds.close()
        assert sel == recorded
        assert meta.get("columns") == recorded

    def test_physical_ranges(self):
        ds = spifs.open_reader(GOLDEN_NC)
        try:
            for g in ds.groups:
                grp = ds.groups[g]
                T = np.asarray(grp.variables["T"][:])
                assert np.all((T > 150.0) & (T < 330.0))
                qt = np.asarray(grp.variables["qt"][:])
                assert np.all((qt >= 0.0) & (qt < 0.05))
        finally:
            ds.close()


@needs_golden
@pytest.mark.slow
class TestGoldenReplay:
    """Replay the golden through the coupling layer (ncmod mechanism)."""

    @pytest.fixture(scope="class")
    def replayed(self, tmp_path_factory):
        out = tmp_path_factory.mktemp("replay") / "out"
        with open(os.path.join(GOLDEN, "golden_meta.json")) as f:
            meta = json.load(f)
        cfg = SPConfig(
            gcm_type="ncfile", les_type="ncfile",
            gcm_input_dir=GOLDEN, les_input_dir=GOLDEN,
            gcm_steps=meta["steps"], cplsurf=True, max_num_les=16,
            output_dir=str(out))
        lat_lon = [float(v) for v in meta["poly_lat_lon"]]
        poly = geometry.Polygon(geometry.parse_lat_lons(lat_lon))
        r = SPRunner(cfg, geometries=[poly])
        r.initialize()
        r.run(meta["steps"])
        r.finalize(save_restart=False)
        return r

    def test_all_columns_all_steps_compared(self, replayed):
        mm = replayed.gcm.mismatches
        # 7 tendency vars x 16 columns x (steps - 1) comparison rounds
        # (the final set_gcm_tendencies of step N lands after the last
        # recorded row only when N < recorded steps)
        assert len(mm) >= 7 * 16 * 90

    def test_tendencies_match_recording(self, replayed):
        ds = spifs.open_reader(GOLDEN_NC)
        try:
            scale = {}
            for g in ds.groups:
                for var in ("f_U", "f_V", "f_T", "f_SH", "f_QL", "f_QI",
                            "f_A"):
                    v = float(np.nanmax(np.abs(
                        np.asarray(ds.groups[g].variables[var][:]))))
                    scale[var] = max(scale.get(var, 0.0), v)
        finally:
            ds.close()
        worst = {}
        for step, var, col, d in replayed.gcm.mismatches:
            worst[var] = max(worst.get(var, 0.0), d)
        for var, d in worst.items():
            tol = 1e-5 * max(scale[var], 1e-30)
            assert d <= tol, (var, d, scale[var])

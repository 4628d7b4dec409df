"""spifs.nc output: the reference's observable, same variables.

The reference writes one netCDF-4 group per superparameterized (or
output-only) column holding ~45 variables: GCM profiles (UPPERCASE), LES
profiles (lowercase), both-direction forcings (f_*), surface scalars and
nudge diagnostics — the variable list of /root/reference/splib/spio.py:
88-225 (naming convention README.md:127-128).

Here the file is netCDF classic (CDF-2, io/nc3.py), which has no groups:
each per-column variable is ONE variable over (Time, column[, level]),
with level ``zf`` for LES profiles and ``oifs_height`` for GCM profiles,
and ``column_index``, ``lat``, ``lon`` and ``is_les`` stored per column.
Cells never written (an output-only column's LES variables, a step that
skipped a variable) hold NaN, the variables' _FillValue. ``open_reader``
gives back the reference's per-column view, ``ds.groups[str(col)]
.variables[name][...]``.

The write cursor advances via update_time, matching spio.update_time
(spio.py:68-72); each step's values collect in one record buffer that
sync writes to disk as one contiguous record, under a lock so a
background writer thread can flush while the LES fleet computes
(spio.py:76-84).
"""

import logging
import threading

import numpy as np

from . import nc3

log = logging.getLogger(__name__)

LES_PROFILE_VARS = [
    ("u", "m/s"), ("v", "m/s"), ("thl", "K"), ("qt", "1"), ("ql", "1"),
    ("ql_ice", "1"), ("ql_water", "1"), ("qr", "1"), ("t", "K"),
    ("t_", "K"), ("f_u", "m/s"), ("f_v", "m/s"), ("f_thl", "K/s"),
    ("f_qt", "1/s"), ("presf", "Pa/s"), ("rhof", "kg/m^3"),
    ("rhobf", "kg/m^3"),
]
GCM_FORCING_VARS = [
    ("f_U", "m/s"), ("f_V", "m/s"), ("f_T", "K/s"), ("f_SH", "1/s"),
    ("f_QL", "1/s"), ("f_QI", "1/s"), ("f_A", "1/s"),
]
GCM_PROFILE_VARS = [
    ("U", "m/s"), ("V", "m/s"), ("T", "K"), ("SH", "1"), ("QL", "1"),
    ("QI", "1"), ("Pf", "Pa"), ("Ph", "Pa"), ("Tv", "K"), ("Zf", "m"),
    ("Zh", "m"), ("THL", "K"), ("QT", "1"), ("A", "1"), ("A_d", "1"),
]
SURFACE_VARS = [("Psurf", "Pa"), ("rain", "kg / m^2"),
                ("rainrate", "kg / m^2h")]
SURFACE_FLUX_VARS = [
    ("z0m", "m"), ("z0h", "m"), ("wthl", "K m/s"), ("wqt", "kg/kg m/s"),
    ("TLflux", "W/m^2"), ("TSflux", "W/m^2"), ("SHflux", "kg / m^2s"),
    ("QLflux", "kg / m^2s"), ("QIflux", "kg / m^2s"),
]


NUDGE_VARS = [("qt_std", "1"), ("qt_alpha", "1/s"), ("qt_beta", "1")]
# variables only superparameterized (LES) columns carry
LES_ONLY = {n for n, _ in LES_PROFILE_VARS + NUDGE_VARS + GCM_FORCING_VARS}
COLUMN_VARS = [("column_index", "i4", ""), ("lat", "f4", "deg"),
               ("lon", "f4", "deg"), ("is_les", "i4", "")]


class SpifsWriter:
    """spifs.nc writer; one instance per run.

    Columns are declared with add_les_column / add_output_column before
    the first update_time, which fixes the file's layout."""

    def __init__(self, path, gcm_ktot, les_info=None, start_time=None,
                 append=False, with_surf_vars=True, with_nudge_vars=False):
        """les_info: dict with x, y, zf coordinate arrays (None: no LES
        axes). with_nudge_vars: the qt variance-nudge diagnostics
        (qt_forcing=variance) get variables."""
        self.path = path
        self.lock = threading.Lock()
        self.step = -1
        self._rec = None
        self.columns = {}        # grid index -> (position, is_les)
        if append:
            self.ds = nc3.Dataset(path, "a")
            v = self.ds.variables
            for k, (col, les) in enumerate(zip(v["column_index"][:],
                                               v["is_les"][:])):
                self.columns[int(col)] = (k, bool(les))
            self.step = self.ds.numrecs - 1
            if self.step >= 0:
                self._rec = {n: var[self.step] for n, var in v.items()
                             if var.is_record}
            return
        self.ds = None
        self._gcm_ktot = int(gcm_ktot)
        self._les_info = les_info
        self._start = start_time
        self._surf = with_surf_vars
        self._nudge = with_nudge_vars
        self._coords = []        # (index, lat, lon, is_les)

    # -- column declaration --------------------------------------------------

    def add_les_column(self, index, lat, lon):
        self._add_column(index, lat, lon, True)

    def add_output_column(self, index, lat, lon):
        self._add_column(index, lat, lon, False)

    def _add_column(self, index, lat, lon, is_les):
        if int(index) in self.columns:
            return
        if self.ds is not None:
            raise RuntimeError("column %s declared after the first record"
                               % index)
        self.columns[int(index)] = (len(self._coords), is_les)
        self._coords.append((int(index), float(lat), float(lon), is_les))

    def _define(self):
        """Lay the file out once every column is known."""
        ds = self.ds = nc3.Dataset(self.path, "w")
        info = self._les_info
        ds.createDimension("Time", None)
        ds.createDimension("column", max(len(self._coords), 1))
        ds.createDimension("oifs_height", self._gcm_ktot)
        if info is not None:
            for nm in ("x", "y", "zf"):
                ds.createDimension(nm, len(info[nm]))
                ds.createVariable(nm, "f4", (nm,), units="m")
        ds.createVariable("Time", "f4", ("Time",),
                          units="s since " + str(self._start))
        for nm, dt, unit in COLUMN_VARS:
            ds.createVariable(nm, dt, ("column",),
                              **({"units": unit} if unit else {}))
        nan = np.float32(np.nan)
        prof = ("Time", "column", "oifs_height")
        for nm, unit in GCM_PROFILE_VARS:
            ds.createVariable(nm, "f4", prof, units=unit, _FillValue=nan)
        srf = SURFACE_VARS + (SURFACE_FLUX_VARS if self._surf else [])
        for nm, unit in srf:
            ds.createVariable(nm, "f4", ("Time", "column"), units=unit,
                              _FillValue=nan)
        if any(c[3] for c in self._coords):
            les = LES_PROFILE_VARS + (NUDGE_VARS if self._nudge else [])
            for nm, unit in les:
                ds.createVariable(nm, "f4", ("Time", "column", "zf"),
                                  units=unit, _FillValue=nan)
            for nm, unit in GCM_FORCING_VARS:
                ds.createVariable(nm, "f4", prof, units=unit,
                                  _FillValue=nan)
        ds.enddef()
        if info is not None:
            for nm in ("x", "y", "zf"):
                ds.put(nm, np.asarray(info[nm], np.float32))
        if self._coords:
            idx, lat, lon, les = zip(*self._coords)
            ds.put("column_index", np.asarray(idx, np.int32))
            ds.put("lat", np.asarray(lat, np.float32))
            ds.put("lon", np.asarray(lon, np.float32))
            ds.put("is_les", np.asarray(les, np.int32))

    # -- writing -------------------------------------------------------------

    def update_time(self, t):
        """Advance the cursor to the next record, stamped with time t (s)."""
        with self.lock:
            if self.ds is None:
                self._define()
            self._write_record()
            self.step = self.ds.numrecs if self._rec is None else \
                self.step + 1
            self._rec = {n: np.full(v.inner_shape, np.nan, np.float32)
                         for n, v in self.ds.variables.items()
                         if v.is_record}
            self._rec["Time"][...] = t

    def write_column(self, index, lock=False, **kwargs):
        """Write named arrays into column `index` at the cursor.

        Unknown variables are logged and skipped, like spio.write_les_data
        (spio.py:228-242); so are the LES variables of an output-only
        column."""
        pos, is_les = self.columns.get(int(index), (None, False))
        if pos is None:
            log.error("write to unknown column %s", index)
            return
        if self._rec is None:
            log.error("write to column %s before update_time", index)
            return
        if lock:
            self.lock.acquire()
        try:
            for var, arr in kwargs.items():
                buf = self._rec.get(var)
                if buf is None or (var in LES_ONLY and not is_les):
                    log.error("write to uninitialized variable %s", var)
                    continue
                buf[pos] = np.asarray(arr, np.float32)
        finally:
            if lock:
                self.lock.release()

    def _write_record(self):
        if self._rec is not None:
            self.ds.put_record(self.step, self._rec)

    def sync(self):
        with self.lock:
            if self.ds is None:
                self._define()
            self._write_record()
            self.ds.sync()

    def close(self):
        self.sync()
        self.ds.close()


class NullWriter:
    """Writer stand-in for non-zero processes in a multi-controller run.

    The reference's netCDF file is written only by the master rank
    (run_T21_nospawn.sh rank 0); here every process executes the same host
    loop, so processes != 0 write into this sink instead of spifs.nc.
    """

    is_null = True
    step = -1

    def add_les_column(self, *a, **k):
        return None

    def add_output_column(self, *a, **k):
        return None

    def update_time(self, t):
        pass

    def write_column(self, index, lock=False, **kwargs):
        pass

    def sync(self):
        pass

    def close(self):
        pass


class ColumnVariable:
    """One column's slice of a (Time, column[, level]) variable."""

    def __init__(self, var, pos):
        self._var, self._pos = var, pos
        self.units = var.units

    @property
    def shape(self):
        s = self._var.shape
        return s[:1] + s[2:] if self._var.is_record else ()

    def __getitem__(self, idx):
        v = self._var.view()
        col = v[:, self._pos] if self._var.is_record else v[self._pos]
        return np.asarray(col[idx], col.dtype.newbyteorder("="))

    def __len__(self):
        return self.shape[0]


class ColumnGroup:
    def __init__(self, ds, pos, is_les):
        self.variables = {
            n: ColumnVariable(v, pos) for n, v in ds.variables.items()
            if "column" in v.dimensions and (is_les or n not in LES_ONLY)}


class SpifsReader:
    """Read view with the reference's per-column group layout."""

    def __init__(self, path):
        self._ds = nc3.Dataset(path, "r")
        self.variables = self._ds.variables
        self.dimensions = self._ds.dimensions
        v = self.variables
        self.groups = {
            str(int(col)): ColumnGroup(self._ds, k, bool(les))
            for k, (col, les) in enumerate(zip(v["column_index"][:],
                                               v["is_les"][:]))}

    def close(self):
        self._ds.close()


def open_reader(path):
    """Read-mode view for replay/verification tooling."""
    return SpifsReader(path)

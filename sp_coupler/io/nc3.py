"""netCDF classic files (CDF-2, 64-bit offset) with numpy alone.

The on-disk format is the one netCDF-3 tools read (netcdf-c, netCDF4-
python, xarray, scipy.io.netcdf_file): a big-endian header of dimensions,
attributes and variables, then the fixed-size variables, then the records
of the one unlimited dimension. Records are laid out back to back, so
appending a time step is one contiguous write at the end of the file and
a restarted run reopens the file in mode "a" and carries on.

Writing: create dimensions and variables, ``enddef()``, then ``put`` a
variable (one record of it, for a record variable) or ``put_record`` a
whole record in one write. Reading: every variable is a numpy view over
a memory map of the file, converted to native byte order only where it
is indexed.
"""

import struct

import numpy as np

_DIMENSION, _VARIABLE, _ATTRIBUTE = 0x0A, 0x0B, 0x0C
_TYPES = {1: "i1", 2: "S1", 3: "i2", 4: "i4", 5: "f4", 6: "f8"}
_NCTYPE = {np.dtype(v).str[1:]: k for k, v in _TYPES.items()}
_FILL = {1: -127, 2: 0, 3: -32767, 4: -2147483647,
         5: 9.9692099683868690e+36, 6: 9.9692099683868690e+36}


def _pad4(n):
    return (n + 3) & ~3


def _nctype(dtype):
    code = _NCTYPE.get(np.dtype(dtype).str[1:])
    if code is None:
        raise TypeError("no netCDF-3 type for %s" % dtype)
    return code


def _attr_value(value):
    """Attribute value -> (nc_type, big-endian bytes, element count)."""
    if isinstance(value, str):
        raw = value.encode()
        return 2, raw, len(raw)
    arr = np.atleast_1d(np.asarray(value))
    if arr.dtype.kind == "i" and arr.dtype.itemsize == 8:
        arr = arr.astype(np.int32)
    code = _nctype(arr.dtype)
    return code, arr.astype(">" + _TYPES[code]).tobytes(), arr.size


class Variable:
    """One variable; ``var[idx]`` reads, ``len(var)`` counts records."""

    def __init__(self, ds, name, dims, nctype, attrs):
        self._ds = ds
        self.name = name
        self.dimensions = tuple(dims)
        self.nctype = nctype
        self.dtype = np.dtype(_TYPES[nctype])
        self.attrs = dict(attrs)
        self.begin = 0
        self.vsize = 0

    @property
    def is_record(self):
        return bool(self.dimensions) and self.dimensions[0] == \
            self._ds.record_dim

    @property
    def inner_shape(self):
        dims = self.dimensions[1:] if self.is_record else self.dimensions
        return tuple(self._ds.dimensions[d] for d in dims)

    @property
    def shape(self):
        lead = (self._ds.numrecs,) if self.is_record else ()
        return lead + self.inner_shape

    @property
    def units(self):
        return self.attrs.get("units", "")

    @property
    def fill_value(self):
        return self.attrs.get("_FillValue", _FILL[self.nctype])

    def nbytes(self):
        """Bytes of one record (record variable) or of all the data."""
        return int(np.prod(self.inner_shape, dtype=np.int64)
                   * self.dtype.itemsize)

    def view(self):
        """Big-endian numpy view over the file's memory map."""
        mm = self._ds._map()
        be = self.dtype.newbyteorder(">")
        inner = self.inner_shape
        strides = tuple(int(np.prod(inner[i + 1:], dtype=np.int64))
                        * be.itemsize for i in range(len(inner)))
        if self.is_record:
            return np.ndarray((self._ds.numrecs,) + inner, be, mm,
                              self.begin, (self._ds.recsize,) + strides)
        return np.ndarray(inner, be, mm, self.begin, strides)

    def __getitem__(self, idx):
        return np.asarray(self.view()[idx], self.dtype.newbyteorder("="))

    def __len__(self):
        return self.shape[0]


class Dataset:
    """A CDF-2 file opened for writing ("w"), appending ("a") or reading."""

    def __init__(self, path, mode="r"):
        if mode not in ("w", "a", "r"):
            raise ValueError("mode must be 'w', 'a' or 'r', got %r" % mode)
        self.path = path
        self.mode = mode
        self.dimensions = {}        # name -> length (record dim: None)
        self.variables = {}
        self.attrs = {}
        self.record_dim = None
        self.numrecs = 0
        self.recsize = 0
        self._mm = None
        self._defining = mode == "w"
        self._f = open(path, {"w": "w+b", "a": "r+b", "r": "rb"}[mode])
        if mode != "w":
            self._read_header()

    # -- definition -----------------------------------------------------

    def createDimension(self, name, size=None):
        """size None: the record (unlimited) dimension."""
        assert self._defining, "dimensions are defined before enddef()"
        if size is None:
            if self.record_dim is not None:
                raise ValueError("netCDF-3 has one unlimited dimension")
            self.record_dim = name
        self.dimensions[name] = None if size is None else int(size)

    def createVariable(self, name, dtype, dims=(), **attrs):
        assert self._defining, "variables are defined before enddef()"
        for ax, d in enumerate(dims):
            if d == self.record_dim and ax:
                raise ValueError("the record dimension must come first")
        var = Variable(self, name, dims, _nctype(dtype), attrs)
        self.variables[name] = var
        return var

    def enddef(self):
        """Fix the layout and write the header and the fixed data."""
        fixed = [v for v in self.variables.values() if not v.is_record]
        recs = [v for v in self.variables.values() if v.is_record]
        for v in self.variables.values():
            v.vsize = _pad4(v.nbytes())
        off = _pad4(len(self._header()))
        for v in fixed:
            v.begin = off
            off += v.vsize
        for v in recs:
            v.begin = off
            off += v.vsize
        # a lone record variable is not padded (netCDF classic spec)
        self.recsize = (recs[0].nbytes() if len(recs) == 1
                        else sum(v.vsize for v in recs))
        self._f.seek(0)
        self._f.write(self._header())
        for v in fixed:
            self.put(v.name, np.full(v.inner_shape, v.fill_value))
        self._defining = False

    # -- writing --------------------------------------------------------

    def _encode(self, var, value):
        arr = np.asarray(value)
        shape = var.inner_shape
        arr = (arr.reshape(shape) if arr.size == np.prod(shape, dtype=int)
               else np.broadcast_to(arr, shape))
        raw = np.ascontiguousarray(arr, ">" + _TYPES[var.nctype]).tobytes()
        return raw + b"\0" * (var.vsize - len(raw))

    def put(self, name, value, rec=None):
        """Write a fixed-size variable in full, or record `rec` of a
        record variable."""
        var = self.variables[name]
        off = var.begin
        if var.is_record:
            off += rec * self.recsize
            self.numrecs = max(self.numrecs, rec + 1)
        self._f.seek(off)
        self._f.write(self._encode(var, value)[:var.nbytes()])

    def put_record(self, rec, values):
        """Write record `rec` whole: {name: array} for every record
        variable; a variable left out is written as its fill value."""
        recs = [v for v in self.variables.values() if v.is_record]
        parts = [self._encode(v, values[v.name] if v.name in values
                              else v.fill_value) for v in recs]
        blob = b"".join(parts)[:self.recsize]
        self._f.seek(recs[0].begin + rec * self.recsize)
        self._f.write(blob)
        self.numrecs = max(self.numrecs, rec + 1)

    def sync(self):
        if self.mode == "r":
            return
        self._f.seek(4)
        self._f.write(struct.pack(">I", self.numrecs))
        self._f.flush()

    def close(self):
        if self._f.closed:
            return
        self.sync()
        self._mm = None
        self._f.close()

    # -- header ---------------------------------------------------------

    @staticmethod
    def _name(s):
        raw = s.encode()
        return struct.pack(">I", len(raw)) + raw + b"\0" * (
            _pad4(len(raw)) - len(raw))

    def _attrs(self, attrs):
        if not attrs:
            return struct.pack(">II", 0, 0)
        b = struct.pack(">II", _ATTRIBUTE, len(attrs))
        for k, val in attrs.items():
            code, raw, n = _attr_value(val)
            b += self._name(k) + struct.pack(">II", code, n)
            b += raw + b"\0" * (_pad4(len(raw)) - len(raw))
        return b

    def _header(self):
        dim_ids = {d: i for i, d in enumerate(self.dimensions)}
        b = b"CDF\x02" + struct.pack(">I", self.numrecs)
        if self.dimensions:
            b += struct.pack(">II", _DIMENSION, len(self.dimensions))
            for d, n in self.dimensions.items():
                b += self._name(d) + struct.pack(">I", n or 0)
        else:
            b += struct.pack(">II", 0, 0)
        b += self._attrs(self.attrs)
        if not self.variables:
            return b + struct.pack(">II", 0, 0)
        b += struct.pack(">II", _VARIABLE, len(self.variables))
        for v in self.variables.values():
            b += self._name(v.name) + struct.pack(">I", len(v.dimensions))
            b += b"".join(struct.pack(">I", dim_ids[d])
                          for d in v.dimensions)
            b += self._attrs(v.attrs)
            b += struct.pack(">II", v.nctype, min(v.vsize, 0xFFFFFFFF))
            b += struct.pack(">Q", v.begin)
        return b

    def _read_header(self):
        buf = self._f.read()
        if buf[:4] not in (b"CDF\x01", b"CDF\x02"):
            raise ValueError("%s is not a netCDF classic file" % self.path)
        offset64 = buf[3] == 2
        pos = 4

        def u32():
            nonlocal pos
            pos += 4
            return struct.unpack_from(">I", buf, pos - 4)[0]

        def name():
            nonlocal pos
            n = u32()
            pos += _pad4(n)
            return buf[pos - _pad4(n):pos - _pad4(n) + n].decode()

        def attrs():
            nonlocal pos
            out = {}
            u32()
            for _ in range(u32()):
                key = name()
                code, n = u32(), u32()
                size = n * np.dtype(_TYPES[code]).itemsize
                raw = buf[pos:pos + size]
                pos += _pad4(size)
                out[key] = (raw.decode() if code == 2 else
                            np.frombuffer(raw, ">" + _TYPES[code])
                            .astype(_TYPES[code]))
            return out

        self.numrecs = u32()
        u32()
        names = []
        for _ in range(u32()):
            d, n = name(), u32()
            names.append(d)
            self.dimensions[d] = n if n else None
            if not n:
                self.record_dim = d
        self.attrs = attrs()
        u32()
        for _ in range(u32()):
            vname = name()
            dims = [names[u32()] for _ in range(u32())]
            vattrs = attrs()
            var = Variable(self, vname, dims, u32(), vattrs)
            var.vsize = u32()
            if offset64:
                var.begin = struct.unpack_from(">Q", buf, pos)[0]
                pos += 8
            else:
                var.begin = u32()
            self.variables[vname] = var
        recs = [v for v in self.variables.values() if v.is_record]
        self.recsize = (recs[0].nbytes() if len(recs) == 1
                        else sum(v.vsize for v in recs))

    def _map(self):
        if self._mm is None or len(self._mm) < self._f.seek(0, 2):
            self._f.flush()
            self._mm = np.memmap(self.path, np.uint8, "r")
        return self._mm

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

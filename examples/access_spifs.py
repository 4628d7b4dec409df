#!/usr/bin/env python
"""Read a spifs.nc produced by this framework (or list its contents).

Equivalent of the reference's examples/access-spifs-nc.py: distinguishes
superparameterized columns (with LES variables) from output-only columns,
and prints a profile sample.
"""

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from sp_coupler.io import spifs  # noqa: E402


def main(path):
    ds = spifs.open_reader(path)
    times = np.asarray(ds.variables["Time"][:])
    print(f"{path}: {len(times)} time records "
          f"({times[0]:.0f}..{times[-1]:.0f} s)")
    for name in sorted(ds.groups, key=int):
        g = ds.groups[name]
        kind = "SP column" if "thl" in g.variables else "output column"
        lat = float(g.variables["lat"][()])
        lon = float(g.variables["lon"][()])
        print(f"  group {name}: {kind} at ({lat:.2f}N, {lon:.2f}E), "
              f"{len(g.variables)} variables")
    sp_groups = [n for n in ds.groups if "thl" in ds.groups[n].variables]
    if sp_groups and len(times):
        g = ds.groups[sp_groups[0]]
        thl = np.asarray(g.variables["thl"][-1])
        T = np.asarray(g.variables["T"][-1])
        print(f"\ncolumn {sp_groups[0]}, last record:")
        print("  LES thl (sfc..top):", np.array2string(thl[:5], precision=2),
              "...", np.array2string(thl[-3:], precision=2))
        print("  GCM T  (top..sfc):", np.array2string(T[:3], precision=2),
              "...", np.array2string(T[-3:], precision=2))
    ds.close()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "spifs.nc")

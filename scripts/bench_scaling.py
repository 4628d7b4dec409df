#!/usr/bin/env python
"""Weak-scaling efficiency sweep (BASELINE metric 3).

Usage: python scripts/bench_scaling.py [--sizes 1,2,4,8] [--nx 32]
       [--nz 64] [--per-dev 2] [--substeps 12] [--out SCALING.json]

On CPU set XLA_FLAGS=--xla_force_host_platform_device_count=N (the
tests' virtual mesh); on a multi-GPU host it measures the real
interconnect with the identical program.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--nz", type=int, default=64)
    ap.add_argument("--per-dev", type=int, default=2)
    ap.add_argument("--substeps", type=int, default=12)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sizes = ([int(s) for s in args.sizes.split(",") if s]
             if args.sizes else None)
    from sp_coupler.runtime import scalebench
    r = scalebench.measure(sizes=sizes, per_dev=args.per_dev, nx=args.nx,
                           ny=args.nx, nz=args.nz, substeps=args.substeps,
                           reps=args.reps)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(r, f, indent=1)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Worker process for the multi-controller end-to-end test.

Launched (twice) by tests/test_multiprocess.py with SPTPU_DIST_* env set:
each process owns 4 virtual CPU devices; jax.distributed joins them into
one 8-device runtime and the driver runs the SAME fused coupled loop it
runs single-process (reference contract: the nospawn MPMD launch,
/root/reference/run_T21_nospawn.sh:18-25, where only rank 0 writes).

Usage: python tests/mp_worker.py <output_dir> <n_steps>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)


def main():
    outdir, n_steps = sys.argv[1], int(sys.argv[2])
    from sp_coupler.config import SPConfig
    from sp_coupler.runtime.driver import SPRunner
    from sp_coupler.utils import geometry

    cfg = SPConfig(gcm_type="sptpu", les_type="sptpu",
                   gcm_truncation=10, gcm_levels=8, gcm_dt=600.0,
                   les_itot=16, les_jtot=16, les_ktot=24,
                   les_xsize=3200.0, les_ysize=3200.0, les_dz=100.0,
                   les_dt=5.0, mesh_les=2, les_num_procs=4, max_num_les=2,
                   les_cross=True, les_cross_heights=(2, 10),
                   les_cross_dtav=60.0,
                   output_dir=outdir)
    r = SPRunner(cfg, [geometry.Point((300.0, 15.0))])
    r.initialize()
    assert r.mesh is not None, "mesh must span both processes"
    assert r.coupled is not None
    r.run(n_steps)
    r.finalize()
    print("mp_worker done: process %d/%d" % (
        jax.process_index(), jax.process_count()))


if __name__ == "__main__":
    main()

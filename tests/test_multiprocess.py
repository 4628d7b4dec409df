"""Multi-controller end-to-end: 2 jax.distributed CPU processes run the
fused coupled loop and must produce the same spifs.nc as 1 process.

The reference's whole launch story is multi-node MPMD
(/root/reference/run_T21_nospawn.sh:18-25, splib/spmpi.py:11-33); here the
equivalent is one jax process per host over one global device mesh, with
rank 0 owning spifs.nc/timing.txt/restart files.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from sp_coupler.io import spifs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_worker.py")
N_STEPS = 3


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(outdir, nprocs):
    """Launch nprocs worker processes; each owns 4 virtual CPU devices."""
    port = _free_port()
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # worker sets its own device count
        env["JAX_PLATFORMS"] = "cpu"
        if nprocs > 1:
            env["SPTPU_DIST_COORD"] = "localhost:%d" % port
            env["SPTPU_DIST_NPROCS"] = str(nprocs)
            env["SPTPU_DIST_PROC_ID"] = str(pid)
        else:
            # single process with all 8 devices: the comparison baseline
            env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, outdir, str(N_STEPS)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=REPO))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, "worker failed:\n" + out[-4000:]
    return outs


def _read_all(path):
    ds = spifs.open_reader(path)
    out = {"Time": np.asarray(ds.variables["Time"][:])}
    for gname, grp in ds.groups.items():
        for vname, v in grp.variables.items():
            out[f"{gname}/{vname}"] = np.asarray(
                v[()] if v.shape == () else v[:])
    ds.close()
    return out


@pytest.mark.slow
def test_two_process_run_matches_single(tmp_path):
    out1 = str(tmp_path / "single")
    out2 = str(tmp_path / "dual")
    _run_workers(out1, 1)
    _run_workers(out2, 2)

    # rank-0-only ownership: exactly one spifs.nc / timing.txt
    nc1 = os.path.join(out1, "spifs.nc")
    nc2 = os.path.join(out2, "spifs.nc")
    assert os.path.exists(nc2)
    assert os.path.exists(os.path.join(out2, "timing.txt"))
    assert os.path.exists(os.path.join(out2, "restart.npz"))

    a, b = _read_all(nc1), _read_all(nc2)
    assert set(a) == set(b)
    worst = {}
    for k in sorted(a):
        if not np.array_equal(a[k], b[k]):
            scale = np.abs(a[k]).max() + 1e-30
            worst[k] = np.abs(a[k] - b[k]).max() / scale
    # same 8-device SPMD program, same mesh, deterministic XLA CPU ->
    # bit-identical output expected; tolerate nothing silently
    assert not worst, f"1p vs 2p spifs.nc differs: {worst}"

    # shard-local per-instance output: EVERY les-work-<col>/cross.nc must
    # exist in the 2-process run (each worker writes the instances it
    # owns — reference README.md:108-111), with the same records as the
    # single-process run
    from sp_coupler.io import spnc
    ds = spifs.open_reader(nc2)
    cols = sorted(int(g) for g in ds.groups)
    ds.close()
    assert len(cols) == 2
    for col in cols:
        p1 = os.path.join(out1, "les-work-%d" % col, "cross.nc")
        p2 = os.path.join(out2, "les-work-%d" % col, "cross.nc")
        assert os.path.exists(p2), f"missing shard-local cross.nc for {col}"
        d1, _ = spnc.read_cdf(p1)
        d2, _ = spnc.read_cdf(p2)
        assert d1["time"].shape == d2["time"].shape
        np.testing.assert_allclose(d2["lwp"], d1["lwp"], atol=1e-6)
        np.testing.assert_allclose(d2["thlxy001"], d1["thlxy001"],
                                   atol=1e-4)

"""Device-mesh construction.

The reference's parallel axes (SURVEY.md section 2.4) map onto named mesh
axes instead of MPI rank blocks:

- ``les``: instance parallelism (one LES per SP column; reference P1 -
  process-per-instance + async RPC) -> batch-axis sharding
- ``x``, ``y``: intra-instance domain decomposition (reference P2 -
  --lesprocs / nprocx x nprocy) -> spatial sharding with halo exchange
- the GCM's spectral transforms (reference P3 - --gcmprocs) are sharded
  over the same devices: grid space along latitude (the ``les`` axis is
  reused, as GCM and LES phases never overlap in time).

Multi-process: jax.distributed.initialize + the same named mesh spanning
all processes. One process can also drive every card of a host (four
NVLink-joined H100s) with no distributed runtime at all.
"""

import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding


def init_distributed():
    """Multi-controller bootstrap (reference: mpiexec MPMD launch lines,
    run_T21_nospawn.sh:18-25; here: one jax process per host).

    The launch is explicit: SPTPU_DIST_COORD (coordinator host:port),
    SPTPU_DIST_NPROCS and SPTPU_DIST_PROC_ID (the framework's own nospawn
    equivalent; works on CPU with gloo collectives — used by the
    multi-process CI test). A failed initialize raises: a process that
    was launched as one rank of many must not carry on alone.

    No-op when not in a multi-process launch. Returns True if a
    multi-process runtime was initialized (or already is up).
    """
    import os

    def already_up():
        # distributed state check that does NOT initialize the XLA
        # backend (jax.process_count() would)
        try:
            from jax._src import distributed
            return distributed.global_state.client is not None
        except Exception:
            return False

    if already_up():
        return jax.process_count() > 1
    coord = os.environ.get("SPTPU_DIST_COORD")
    if coord:
        nprocs = int(os.environ.get("SPTPU_DIST_NPROCS", "1"))
        pid = int(os.environ.get("SPTPU_DIST_PROC_ID", "0"))
        if "cpu" in os.environ.get("JAX_PLATFORMS", "").lower():
            try:  # cross-process CPU collectives need gloo
                jax.config.update("jax_cpu_collectives_implementation",
                                  "gloo")
            except Exception:
                pass
        try:
            jax.distributed.initialize(coord, num_processes=nprocs,
                                       process_id=pid)
        except Exception as e:
            raise RuntimeError(
                "jax.distributed.initialize(%s, num_processes=%d, "
                "process_id=%d) failed: %s" % (coord, nprocs, pid, e)) from e
        return jax.process_count() > 1
    return False


def make_mesh(n_les=None, n_x=1, n_y=1, devices=None):
    """Mesh with axes (les, x, y); defaults to all devices on `les`."""
    devices = devices if devices is not None else jax.devices()
    ndev = len(devices)
    if n_les is None:
        n_les = ndev // (n_x * n_y)
    assert n_les * n_x * n_y == ndev, (
        f"mesh {n_les}x{n_x}x{n_y} != {ndev} devices")
    arr = np.asarray(devices).reshape(n_les, n_x, n_y)
    return Mesh(arr, ("les", "x", "y"))


def single_device_mesh():
    return make_mesh(1, 1, 1, devices=jax.devices()[:1])


def fleet_spec():
    """PartitionSpec for LES fleet state [n_les, (nz), ny, nx]."""
    return P("les")


def fleet_spatial_spec():
    """Fleet state sharded over instances and horizontal space.

    Layout [n_les, nz, ny, nx]: batch over ``les``, y over ``y``, x over
    ``x``; z replicated (vertical couplings — Poisson tridiagonal, cumsum —
    stay local).
    """
    return P("les", None, "y", "x")


def shard_fleet(state, mesh, spatial=False):
    """Apply NamedSharding to every array in an LES fleet pytree."""
    # multi-controller: every process computed the same full-size state
    # host-side; route through numpy so device_put can lay out a global
    # array over non-addressable devices
    multiproc = jax.process_count() > 1

    def put(x):
        if getattr(x, "ndim", 0) >= 3 and spatial:
            nd = NamedSharding(mesh, P(*(("les", None, "y", "x")[: x.ndim])))
        elif getattr(x, "ndim", 0) >= 1:
            nd = NamedSharding(mesh, P("les"))
        else:
            return x
        if multiproc:
            x = np.asarray(x)
        return jax.device_put(x, nd)

    return jax.tree.map(put, state)


def replicate(tree, mesh):
    """Replicate a pytree across the mesh (GCM state on every device).

    Multi-controller: host-visible (addressable) leaves are promoted via
    a host copy + global device_put; leaves already sharded over the
    global mesh (e.g. a lat-band-sharded GCM state) cannot be fetched to
    host, so they are re-laid-out on device by an identity jit with a
    replicated out_sharding (XLA inserts the all-gather)."""
    nd = NamedSharding(mesh, P())
    multiproc = jax.process_count() > 1

    def put(x):
        if (multiproc and isinstance(x, jax.Array)
                and not x.is_fully_addressable):
            return jax.jit(lambda a: a, out_shardings=nd)(x)
        return jax.device_put(np.asarray(x) if multiproc else x, nd)

    return jax.tree.map(put, tree)


def local_les_positions(mesh, n_les):
    """Instance positions whose devices ALL belong to this process.

    The fleet is block-distributed over the `les` mesh axis (GSPMD:
    ceil(n_les / L) per slot); an instance is process-local when every
    device of its les-slot (including its x/y spatial shards) lives on
    this process. Used for shard-local per-instance output
    (io/crossio.py) in multi-controller runs.
    """
    L = mesh.shape["les"]
    per = -(-n_les // L)
    pidx = jax.process_index()
    darr = np.asarray(mesh.devices).reshape(L, -1)
    local = []
    for slot in range(L):
        if all(d.process_index == pidx for d in darr[slot]):
            local.extend(range(slot * per, min((slot + 1) * per, n_les)))
    return local

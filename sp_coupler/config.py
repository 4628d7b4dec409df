"""Run configuration.

The reference keeps its configuration as mutable module globals updated from
JSON or CLI dicts (/root/reference/splib/splib.py:39-72, 436-456). Here the
same knobs (plus device-mesh ones) live in one frozen-by-convention
dataclass; ``read_config`` layers JSON-file / dict / CLI sources the same way
the reference does, ignoring unknown callables and unknown keys.
"""

import dataclasses
import json
import logging
import os
from typing import Optional

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SPConfig:
    # --- run loop (splib.py:39-72 equivalents) ---
    gcm_type: str = "sptpu"            # "sptpu" | "dummy" | "ncfile"
    gcm_steps: int = 10                # number of GCM time steps
    gcm_exp_name: str = "TEST"
    gcm_input_dir: str = ""
    gcm_run_dir: str = "gcm-work"
    gcm_forcing_factor: float = 1.0    # scale factor for forcings upon the GCM
    les_type: str = "sptpu"            # "sptpu" | "dummy" | "ncfile"
    les_dt: float = -1.0               # fixed LES substep (s); <0 = auto from CFL target
    les_spinup: float = 0.0            # LES spinup time (s) before GCM start
    les_spinup_steps: int = 1
    les_spinup_forcing_factor: float = 1.0
    les_exp_name: str = "test"
    les_input_dir: str = ""
    les_run_dir: str = "les-work"
    les_forcing_factor: float = 1.0
    max_num_les: int = -1
    init_les_state: bool = True
    output_dir: str = "spifs-output"
    output_name: str = "spifs.nc"
    dryrun: bool = False
    restart: bool = False
    restart_steps: int = 0             # save a checkpoint every N coupled
                                       # steps; 0 = only at finalize
                                       # (reference: OpenIFS restart_steps
                                       # modfac.py:61, DALES trestart :90)
    cplsurf: bool = False              # couple surface fluxes/roughness
    qt_forcing: str = "sp"             # "sp" | "variance" | "local" | "strong"
    conservative_coarsening: bool = False
    variability_nudge_constant_T: bool = False

    # --- GCM core ---
    gcm_truncation: int = 21           # triangular truncation (T21, T42, ...)
    gcm_levels: int = 19               # hybrid sigma-p levels
    gcm_dt: float = 900.0              # GCM time step (s) (oifs-input/fort.4:52)
    gcm_hybrid: bool = False           # hybrid sigma-p A/B levels
                                       # (OpenIFS-like; False = pure sigma)
    gcm_advection: str = "auto"        # "auto" | "eulerian" | "sl":
                                       # auto = semi-Lagrangian at T63 and
                                       # above (where the Eulerian CFL
                                       # would force tiny steps), Eulerian
                                       # leapfrog below
    gcm_start_date: str = "2000-01-01T00:00:00"

    # --- LES core (dales-input/namoptions.001 equivalents) ---
    les_itot: int = 64
    les_jtot: int = 64
    les_ktot: int = 160
    les_xsize: float = 12800.0         # m
    les_ysize: float = 12800.0         # m
    les_dz: float = 25.0               # m (uniform grid; 160 x 25 m = 4 km top)
    les_nsubsteps: int = 0             # fixed substeps per GCM step
                                       # (DALES ladaptive=.false. mode);
                                       # 0 = adaptive CFL/Peclet stepping
    les_evolve_chunks: int = 1         # device programs per LES evolve; >1
                                       # bounds single-execution device time
                                       # for very large fleets
    les_cross: bool = False            # per-instance cross-section netCDFs
                                       # (DALES &NAMCROSSSECTION lcross;
                                       # written to ODIR/les-work-<col>/)
    les_cross_heights: tuple = (2, 40, 80)  # DALES 1-based crossheight
    les_cross_dtav: float = 60.0       # s statistics cadence (dtav); the
                                       # state is only observable at
                                       # coupled-step boundaries, so the
                                       # effective cadence is
                                       # max(dtav, gcm_dt)
    les_schedule: str = "auto"         # "auto" | "serial" | "batched":
                                       # per-device instance pacing — serial
                                       # runs each instance's adaptive loop
                                       # independently (no straggler
                                       # coupling); batched = one vmapped
                                       # loop paced by the slowest instance
    les_cfl: float = 0.7               # adaptive-substep CFL target
                                       # (namoptions &RUN courant)
    les_peclet: float = 0.1            # adaptive-substep diffusion limit
                                       # (namoptions &RUN peclet)
    les_dt_min: float = 0.2            # adaptive-substep floor (s); dts
                                       # below it are clamped and counted
                                       # as instability flags
    les_advection: str = "hybrid52"    # "cd2" | "hybrid52" (5th horiz / 2nd vert)
    les_subgrid: str = "tke"       # "tke" (DALES default) | "smagorinsky"

    # --- numerics / hardware ---
    seed: int = 42                     # reference seeds numpy with 42 (splib.py:181)
    mesh_les: int = 1                  # device-mesh extent of the LES batch axis
    mesh_x: int = 1                    # intra-LES spatial sharding (x)
    mesh_y: int = 1

    # --- reference process-topology knobs (splib.py:44-65), accepted for
    # drop-in compatibility and mapped onto mesh axes: the per-model MPI
    # rank counts become device-mesh extents, the AMUSE channel and the
    # worker-thread queue have no equivalent in a single SPMD program ---
    gcm_num_procs: int = 1             # --gcmprocs: GCM spatial shards (P3)
    les_num_procs: int = 1             # --lesprocs: intra-LES shards (P2)
    les_queue_threads: int = 0         # --queue: no-op (XLA schedules)
    channel_type: str = "spmd"         # --channel: no-op (no RPC)
    async_evolve: bool = True          # no-op (dispatch is always async)
    gcm_redirect: str = "file"         # no-op (one process)
    les_redirect: str = "file"         # no-op (one process)

    # --- IO ---
    write_every: int = 1
    async_io: bool = True              # write-behind spifs IO: the previous
                                       # step's record is serialized while
                                       # the device runs the current step
                                       # (reference P4); False = flush
                                       # synchronously inside each step
    check_finite: bool = True          # abort cleanly if the LES state
                                       # goes non-finite (failure detection)
    jax_profile: bool = False          # capture a jax profiler trace of
                                       # one coupled step into output_dir
    timing_phases: int = 25            # every N-th fused step runs as the
                                       # pre/evolve/post phase programs
                                       # (same math; outputs ARE the
                                       # trajectory) with host barriers, so
                                       # timing.txt regains real per-phase
                                       # columns at that cadence (reference
                                       # splib.py:340-343); 0 = off, 1 =
                                       # every step

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def les_dx(self):
        return self.les_xsize / self.les_itot

    @property
    def les_dy(self):
        return self.les_ysize / self.les_jtot

    @property
    def output_path(self):
        if os.path.isabs(self.output_name):
            return self.output_name
        return os.path.join(self.output_dir, self.output_name)


def read_config(config, base: Optional[SPConfig] = None) -> SPConfig:
    """Build an SPConfig from a JSON file path, a dict, or None.

    Unknown keys are skipped with a log line, matching splib.read_config
    (splib.py:436-456).
    """
    cfg = base or SPConfig()
    userconf = {}
    if isinstance(config, str):
        if os.path.isfile(config):
            with open(config) as f:
                userconf = json.load(f)
        else:
            log.error("Could not find input configuration file %s", config)
    elif isinstance(config, dict):
        userconf = config
    elif config is not None:
        log.error("Could not read configuration from object of type %s", type(config))
    fields = {f.name for f in dataclasses.fields(SPConfig)}
    updates = {}
    for key, val in userconf.items():
        if callable(val):
            log.info("Skipping callable config entry %s", key)
            continue
        if key in fields:
            updates[key] = val
        else:
            log.info("Ignoring unknown config key %s", key)
    return cfg.replace(**updates)

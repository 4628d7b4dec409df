"""Run loop: initialize / run / step / finalize (splib equivalent).

Orchestrates the coupled system the way /root/reference/splib/splib.py does
(read_config, initialize, run, step, run_spinup, finalize — splib.py:97-432)
but with no RPC: the GCM phases, the batched coupling math, and the LES
fleet evolve are jitted device calls; the host loop only moves small
profile arrays and writes spifs.nc.

Per coupled step (reference call stack SURVEY.md section 3.2):
  phase A + cloud scheme -> gather SP columns -> convert + forcings
  (vmapped) -> [variability nudge] -> LES fleet evolve -> slab profiles ->
  GCM tendencies (remap + scatter) -> phase B -> timing.txt line.
"""

import dataclasses
import datetime
import logging
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as c
from ..config import SPConfig, read_config
from ..utils import geometry
from ..coupling import convert, nudge
from ..models import dummy as dummy_mod
from ..models.les import grid as lgrid, step as lstep, model as les_model
from ..models.les.state import LESForcing
from ..io import spifs

log = logging.getLogger(__name__)

QT_MODES = {"sp": lstep.QT_FORCING_GLOBAL,
            "variance": lstep.QT_FORCING_VARIANCE,
            "local": lstep.QT_FORCING_LOCAL,
            "strong": lstep.QT_FORCING_STRONG}


def create_gcm(cfg: SPConfig, mesh=None):
    if cfg.gcm_type in ("sptpu", "oifs"):
        from ..models.gcm import model as gcm_model
        adv = cfg.gcm_advection
        if adv == "auto":
            # Eulerian leapfrog is CFL-limited to ~dx/u_max; at T63+ the
            # canonical OpenIFS step lengths need semi-Lagrangian advection
            adv = "sl" if cfg.gcm_truncation >= 63 else "eulerian"
        gcfg = gcm_model.GCMConfig(trunc=cfg.gcm_truncation,
                                   nlev=cfg.gcm_levels, dt=cfg.gcm_dt,
                                   start_date=cfg.gcm_start_date,
                                   hybrid=cfg.gcm_hybrid,
                                   advection=adv)
        # --gcmprocs: latitude-band sharding of the spectral transforms
        # over the WHOLE mesh (GCM and LES phases never overlap in time)
        shard_axis = None
        if mesh is not None and cfg.gcm_num_procs > 1:
            shard_axis = ("les", "x", "y")
            log.info("GCM spectral transforms sharded over %d devices",
                     mesh.size)
        return gcm_model.GCMModel(gcfg, seed=cfg.seed, mesh=mesh,
                                  shard_axis=shard_axis)
    if cfg.gcm_type == "dummy":
        return dummy_mod.DummyGCM()
    if cfg.gcm_type in ("ncfile", "spifsnc_gcm"):
        from ..models import ncreplay
        return ncreplay.ReplayGCM(os.path.join(cfg.gcm_input_dir, "spifs.nc"))
    raise ValueError("unknown gcm_type " + cfg.gcm_type)


def create_fleet(cfg: SPConfig, n_les):
    if cfg.les_type in ("sptpu", "dales"):
        grid = lgrid.LESGrid.from_config(cfg)
        phys = lstep.LESPhysics(
            scheme=cfg.les_advection,
            subgrid=cfg.les_subgrid,
            qt_forcing=QT_MODES[cfg.qt_forcing])
        dt = cfg.les_dt if cfg.les_dt > 0 else 5.0
        return les_model.LESFleet(grid, phys, n_les, dt, seed=cfg.seed,
                                  schedule=cfg.les_schedule,
                                  cfl=cfg.les_cfl, peclet=cfg.les_peclet,
                                  dt_min=cfg.les_dt_min,
                                  n_substeps=cfg.les_nsubsteps)
    if cfg.les_type == "dummy":
        return dummy_mod.DummyLESFleet(n_les)
    if cfg.les_type in ("ncfile", "spifsnc_les"):
        from ..models import ncreplay
        return ncreplay.ReplayLESFleet(
            os.path.join(cfg.les_input_dir, "spifs.nc"), n_les)
    raise ValueError("unknown les_type " + cfg.les_type)


class SPRunner:
    """One coupled superparameterized run."""

    def __init__(self, config=None, geometries=(), output_geometries=()):
        self.cfg = config if isinstance(config, SPConfig) else read_config(
            config)
        self.geometries = list(geometries)
        self.output_geometries = list(output_geometries)
        self.writer = None
        self.gcm = None
        self.fleet = None
        self.instances = []
        self.sp_cols = []
        self.output_cols = []
        self.prev_profiles = None
        self.rain_last = None
        self.firststep = True
        self.step_index = 0  # coupled steps taken (write_every cadence)
        self.timing_file = None
        self._timing_header_done = False
        self._les_zf = None
        self._les_zh = None

    # ------------------------------------------------------------------ init

    def initialize(self):
        cfg = self.cfg

        # device mesh: --mesh_les / --lesprocs map the reference's MPI rank
        # blocks (P1 instance parallelism, P2 intra-LES decomposition) onto
        # named mesh axes; --gcmprocs lat-shards the GCM transforms (P3).
        # Built first: it may bring up the multi-controller runtime, and
        # everything below needs to know which process owns the output
        # files (reference: only the master rank writes, spio.py).
        self.mesh = self._build_mesh()
        self.io_proc = jax.process_index() == 0

        # clobber guard (splib.py:101-102) — but an EMPTY dir is fine: in a
        # multi-controller run on a shared filesystem a sibling process may
        # already have created it
        if (self.io_proc and not cfg.restart
                and os.path.isdir(cfg.output_dir)
                and os.listdir(cfg.output_dir)):
            raise RuntimeError("output dir %s exists" % cfg.output_dir)
        os.makedirs(cfg.output_dir, exist_ok=True)

        self.gcm = create_gcm(cfg, self.mesh)
        self.gcm.initialize_code()
        self.gcm.commit_parameters()
        self.gcm.commit_grid()
        self.gcm.set_vdf_in_sp_mask(not cfg.cplsurf)

        lons = np.asarray(self.gcm.longitudes, float)
        lats = np.asarray(self.gcm.latitudes, float)
        points = list(zip(lons, lats))
        self.sp_cols = [int(i) for i in geometry.get_mask_indices(
            points, self.geometries, cfg.max_num_les)]
        out_idx = geometry.get_mask_indices(points, self.output_geometries)
        self.output_cols = sorted(set(out_idx) - set(self.sp_cols))
        log.info("SP columns: %s", self.sp_cols)

        if cfg.dryrun:
            np.savetxt(os.path.join(cfg.output_dir, "gridpoints.txt"),
                       np.column_stack((lons, lats)), fmt="%10.6f")
            return self

        n = len(self.sp_cols)
        self.fleet = create_fleet(cfg, max(n, 1))
        self.instances = []
        if isinstance(self.fleet, les_model.LESFleet):
            for k, col in enumerate(self.sp_cols):
                inst = les_model.LESInstance(self.fleet, k)
                inst.grid_index = col
                inst.lat, inst.lon = lats[col], lons[col]
                self.instances.append(inst)
        for col in self.sp_cols:
            self.gcm.set_mask(col)
        self.gcm.set_vdf_in_sp_mask(not cfg.cplsurf)
        self._les_zf = jnp.asarray(self.fleet.get_zf(), jnp.float32)
        nz = self.fleet.get_ktot()
        self._les_zh_full = jnp.asarray(
            np.concatenate([[0.0], np.asarray(self.fleet.get_zh())]),
            jnp.float32)

        start = self.gcm.get_start_datetime() - datetime.timedelta(
            seconds=cfg.les_spinup)
        les_info = None
        if n > 0:
            dx, dy = self.fleet.get_dx(), self.fleet.get_dy()
            les_info = {
                "x": (np.arange(self.fleet.get_itot()) + 0.5) * dx,
                "y": (np.arange(self.fleet.get_jtot()) + 0.5) * dy,
                "zf": np.asarray(self.fleet.get_zf()),
            }
        if self.io_proc:
            self.writer = spifs.SpifsWriter(
                cfg.output_path, self.gcm.get_ktot(), les_info, start,
                append=cfg.restart, with_surf_vars=cfg.cplsurf,
                with_nudge_vars=cfg.qt_forcing == "variance")
        else:
            self.writer = spifs.NullWriter()
        if not cfg.restart:
            for inst_i, col in enumerate(self.sp_cols):
                self.writer.add_les_column(col, lats[col], lons[col])
            for col in self.output_cols:
                self.writer.add_output_column(col, lats[col], lons[col])

        self.rain_last = np.zeros(max(n, 1))

        # per-instance LES cross-section output (DALES writes surf_xy/
        # cross-section netCDFs per work dir, reference README.md:108-111)
        self.crossio = None
        self._cross_next = -float("inf")
        if (cfg.les_cross and isinstance(self.fleet, les_model.LESFleet)
                and n > 0):
            # multi-controller: each process writes cross.nc for the
            # instances it owns (reference: every DALES instance writes
            # its own files, README.md:108-111); single process owns all
            positions = list(range(n))
            if jax.process_count() > 1 and self.mesh is not None:
                from ..parallel import mesh as pmesh
                positions = pmesh.local_les_positions(self.mesh, n)
                log.info("les_cross shard-local: process %d owns "
                         "instances %s", jax.process_index(), positions)
            # construct on EVERY process (possibly with zero local
            # writers): _write_cross's get_fields() is a collective
            # program — all processes must keep executing it in lockstep
            from ..io import crossio as crossio_mod
            self.crossio = crossio_mod.FleetCrossIO(
                cfg.output_dir, self.fleet.grid,
                [self.sp_cols[p] for p in positions],
                heights=tuple(h - 1 for h in cfg.les_cross_heights),
                positions=positions)
            log.info("per-instance cross-section output: les-work-*/"
                     "cross.nc every %.0f s", max(cfg.les_cross_dtav,
                                                  cfg.gcm_dt))

        # fused fast path: native GCM + native LES -> one jitted program per
        # coupled step (coupling/coupler.py); the host only writes spifs.nc
        self.coupled = None
        if (hasattr(self.gcm, "core")
                and isinstance(self.fleet, les_model.LESFleet) and n > 0):
            from ..coupling.coupler import CoupledStepFn
            dt_max = cfg.les_dt if cfg.les_dt > 0 else 15.0
            self.coupled = CoupledStepFn(
                self.gcm.core, self.fleet.grid, self.fleet.phys,
                np.asarray(self.sp_cols, np.int32), dt_les=dt_max,
                n_substeps=cfg.les_nsubsteps,
                cfl=cfg.les_cfl, peclet=cfg.les_peclet,
                dt_min=cfg.les_dt_min,
                les_forcing_factor=cfg.les_forcing_factor,
                gcm_forcing_factor=cfg.gcm_forcing_factor,
                conservative=cfg.conservative_coarsening,
                cplsurf=cfg.cplsurf,
                qt_variance=(cfg.qt_forcing == "variance"),
                constant_T=cfg.variability_nudge_constant_T,
                mesh=self.mesh,
                seed=cfg.seed,
                evolve_chunks=cfg.les_evolve_chunks,
                serial_evolve=cfg.les_schedule)

        if not cfg.restart:
            # first half step so U,V,T are initialized (splib.py:183-189)
            self.gcm.evolve_model_until_cloud_scheme()
            self.gcm.evolve_model_cloud_scheme()
            self._half_step_done = True
            spinup_dt = cfg.les_spinup / max(cfg.les_spinup_steps, 1)
            self.writer.update_time(spinup_dt if cfg.les_spinup > 0
                                    else self.gcm.get_timestep())

            if cfg.init_les_state and n > 0:
                conv = self._gather_convert(write=True)
                self.fleet.init_states(
                    u=np.asarray(conv.u), v=np.asarray(conv.v),
                    thl=np.asarray(conv.thl), qt=np.asarray(conv.qt),
                    ps=np.asarray(conv.ps),
                    start_time=-cfg.les_spinup)
                self._shard_fleet_state()
                if cfg.les_spinup > 0:
                    self.run_spinup(cfg.les_spinup, cfg.les_spinup_steps)
            elif n > 0 and cfg.les_input_dir:
                # DALES-style cold start from the case's prof.inp (the
                # reference LES initializes itself from its deck when the
                # coupler does not push state)
                from ..utils import decks
                prof = decks.read_dales_prof(cfg.les_input_dir,
                                             cfg.les_exp_name)
                if prof is not None:
                    zf = np.asarray(self._les_zf)
                    cols = {k: np.interp(zf, prof["z"], prof[k])
                            for k in ("u", "v", "thl", "qt")}
                    rep = {k: np.repeat(v[None], n, 0)
                           for k, v in cols.items()}
                    self.fleet.init_states(
                        u=rep["u"], v=rep["v"], thl=rep["thl"],
                        qt=rep["qt"], ps=np.full(n, 1.0e5, np.float32),
                        start_time=-cfg.les_spinup)
                    self._shard_fleet_state()
                    if cfg.les_spinup > 0:
                        conv = self._gather_convert(write=True)
                        self.run_spinup(cfg.les_spinup,
                                        cfg.les_spinup_steps)
        else:
            self._half_step_done = False
            from ..io import restart as restart_io
            restart_io.load(self)
            self._shard_fleet_state()
        return self

    def _build_mesh(self):
        """Device mesh from the config's topology knobs (or None).

        The reference's --lesprocs (MPI ranks per DALES, P2) becomes the
        intra-LES x*y spatial sharding; --queue and --channel have no
        SPMD equivalent and are logged as accepted no-ops.
        """
        cfg = self.cfg
        from ..parallel import mesh as pmesh
        if pmesh.init_distributed():
            log.info("multi-controller runtime: process %d/%d, %d devices",
                     jax.process_index(), jax.process_count(),
                     len(jax.devices()))
        if cfg.les_queue_threads > 0:
            log.info("--queue %d accepted (no-op: the LES fleet is one "
                     "batched device computation)", cfg.les_queue_threads)
        if cfg.channel_type != "spmd":
            log.info("--channel %s accepted (no-op: no RPC in a single "
                     "SPMD program)", cfg.channel_type)
        # reference work-dir / redirect knobs: no external model processes
        # exist, so there are no per-model working directories or stdout
        # streams to redirect — accepted, logged, ignored
        for knob, default in (("gcm_run_dir", "gcm-work"),
                              ("les_run_dir", "les-work"),
                              ("gcm_redirect", "file"),
                              ("les_redirect", "file"),
                              ("gcm_exp_name", "TEST")):
            val = getattr(cfg, knob)
            if val != default:
                log.info("--%s %s accepted (no-op: no external model "
                         "processes in a single SPMD program)", knob, val)
        n_x, n_y = cfg.mesh_x, cfg.mesh_y
        if cfg.les_num_procs > 1 and n_x * n_y == 1:
            n_x = int(np.sqrt(cfg.les_num_procs))
            while cfg.les_num_procs % n_x:
                n_x -= 1
            n_y = cfg.les_num_procs // n_x
        total = cfg.mesh_les * n_x * n_y
        if total <= 1:
            return None
        ndev = len(jax.devices())
        if total > ndev:
            raise ValueError("mesh (les=%d, x=%d, y=%d) needs %d devices, "
                             "%d available" % (cfg.mesh_les, n_x, n_y, total,
                                               ndev))
        mesh = pmesh.make_mesh(cfg.mesh_les, n_x, n_y,
                               devices=jax.devices()[:total])
        log.info("device mesh: les=%d, x=%d, y=%d", cfg.mesh_les, n_x, n_y)
        return mesh

    def _shard_fleet_state(self):
        """Lay the fleet state out over the mesh (instances + x/y space)."""
        if self.mesh is None or not isinstance(self.fleet,
                                               les_model.LESFleet):
            return
        from ..parallel import mesh as _pm
        if jax.process_count() > 1 and hasattr(self.gcm, "state"):
            # multi-controller: promote the (identical) per-process GCM
            # state to one replicated global array so the fused jit sees
            # consistent global inputs on every process
            self.gcm.state = _pm.replicate(self.gcm.state, self.mesh)
        n = self.fleet.n
        if n % self.mesh.shape["les"]:
            log.warning("%d LES instances not divisible by mesh les=%d; "
                        "fleet stays unsharded", n, self.mesh.shape["les"])
            return
        from ..parallel import mesh as pmesh
        spatial = self.mesh.shape["x"] * self.mesh.shape["y"] > 1
        self.fleet.state = pmesh.shard_fleet(self.fleet.state, self.mesh,
                                             spatial=spatial)

    # ------------------------------------------------------- coupling pieces

    def _gcm_profiles(self, cols):
        """dict of [n, L] numpy arrays for the given columns."""
        out = {}
        for var in ("U", "V", "T", "SH", "QL", "QI", "Pfull", "Phalf",
                    "A", "Zgfull", "Zghalf"):
            out[var] = np.asarray(self.gcm.get_profile_fields(var, cols))
        return out

    def _gather_convert(self, write):
        """gather_gcm_data + convert_profiles for all SP columns (batched)."""
        prof = self._gcm_profiles(self.sp_cols)
        self._last_gcm_prof = prof
        conv = jax.vmap(lambda p: convert.convert_profiles(p, self._les_zf))(
            {k: jnp.asarray(v, jnp.float32) for k, v in prof.items()})
        self._last_conv = conv
        if write and self.writer is not None:
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col,
                    U=prof["U"][i], V=prof["V"][i], T=prof["T"][i],
                    SH=prof["SH"][i], QL=prof["QL"][i], QI=prof["QI"][i],
                    Pf=prof["Pfull"][i], Ph=prof["Phalf"][i][1:],
                    Zf=np.asarray(conv.Zf[i]), Zh=np.asarray(conv.Zh[i])[1:],
                    Psurf=prof["Phalf"][i][-1], Tv=np.asarray(conv.Tv[i]),
                    THL=np.asarray(conv.THL[i]), QT=np.asarray(conv.QT[i]))
            self._write_output_columns()
        if self.cfg.cplsurf:
            surf = {v: np.asarray(self.gcm.get_surface_field(
                v, self.sp_cols)) for v in ("Z0M", "Z0H", "QLflux", "QIflux",
                                            "SHflux", "TLflux", "TSflux")}
            self._last_surf = surf
        return conv

    def _output_columns_data(self):
        """Fetch the non-SP monitoring columns' record (host numpy)."""
        if not self.output_cols:
            return None
        prof = self._gcm_profiles(self.output_cols)
        conv = jax.vmap(lambda p: convert.convert_profiles(p, self._les_zf))(
            {k: jnp.asarray(v, jnp.float32) for k, v in prof.items()})
        data = []
        for i, col in enumerate(self.output_cols):
            data.append((col, dict(
                U=prof["U"][i], V=prof["V"][i], T=prof["T"][i],
                SH=prof["SH"][i], QL=prof["QL"][i], QI=prof["QI"][i],
                Pf=prof["Pfull"][i], Ph=prof["Phalf"][i][1:],
                Zf=np.asarray(conv.Zf[i]), Zh=np.asarray(conv.Zh[i])[1:],
                Psurf=prof["Phalf"][i][-1], Tv=np.asarray(conv.Tv[i]),
                THL=np.asarray(conv.THL[i]), QT=np.asarray(conv.QT[i]),
                A=prof["A"][i])))
        return data

    def _write_output_columns(self):
        data = self._output_columns_data()
        if data:
            for col, kwargs in data:
                self.writer.write_column(col, **kwargs)

    def _les_profiles(self):
        prof = self.fleet.get_profiles()
        return jax.tree.map(np.asarray, prof)

    def _build_forcings(self, conv, les_prof, dt, factor, write):
        """Batched LESForcing + rain bookkeeping + spifs writes."""
        n = len(self.sp_cols)
        f = jax.vmap(lambda cv, lp: convert.les_forcings(
            cv, lp, dt, factor))(
                conv, {k: jnp.asarray(les_prof[k]) for k in
                       ("U", "V", "THL", "QT", "QL", "PS")})
        rain = np.asarray(les_prof["Rain"])
        rainrate = (rain - self.rain_last) / dt
        self.rain_last = rain.copy()

        if self.cfg.cplsurf:
            surf = self._last_surf
            z0m, z0h, wthl, wqt = convert.convert_surface_fluxes(
                {k: jnp.asarray(v) for k, v in surf.items()},
                jnp.asarray(self._last_gcm_prof["Phalf"][:, -1]),
                jnp.asarray(self._last_gcm_prof["T"][:, -1]))
        else:
            z0m = jnp.full(n, 0.1)
            z0h = jnp.full(n, 0.02)
            wthl = jnp.zeros(n)
            wqt = jnp.zeros(n)

        forcing = LESForcing(
            f_u=f["f_u"], f_v=f["f_v"], f_thl=f["f_thl"], f_qt=f["f_qt"],
            f_ql=f["f_ql"], f_ps=f["f_ps"], ql_ref=conv.ql,
            wthl=wthl, wqt=wqt, z0m=z0m, z0h=z0h)

        if write:
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col, f_u=np.asarray(f["f_u"][i]),
                    f_v=np.asarray(f["f_v"][i]),
                    f_thl=np.asarray(f["f_thl"][i]),
                    f_qt=np.asarray(f["f_qt"][i]),
                    rain=rain[i], rainrate=rainrate[i] * 3600.0)
                if self.cfg.cplsurf:
                    self.writer.write_column(
                        col, z0m=float(z0m[i]), z0h=float(z0h[i]),
                        wthl=float(wthl[i]), wqt=float(wqt[i]),
                        TLflux=self._last_surf["TLflux"][i],
                        TSflux=self._last_surf["TSflux"][i],
                        SHflux=self._last_surf["SHflux"][i],
                        QLflux=self._last_surf["QLflux"][i],
                        QIflux=self._last_surf["QIflux"][i])
        return forcing

    def _variability_nudge(self, conv, dt, write):
        """Coupler-side qt variance nudge (qt_forcing=variance).

        Not applied on the first step; its diagnostics are then recorded
        as zeros, as the fused step does."""
        if self.fleet.time <= 0:
            if write:
                zero = np.zeros(self.fleet.get_ktot(), np.float32)
                for col in self.sp_cols:
                    self.writer.write_column(col, qt_alpha=zero,
                                             qt_beta=zero, qt_std=zero)
            return
        fields = self.fleet.get_fields()
        prof = self.fleet.get_profiles()
        key = jax.random.fold_in(jax.random.PRNGKey(self.cfg.seed + 1),
                                 int(self.fleet.time))
        keys = jax.random.split(key, len(self.sp_cols))
        res = jax.vmap(
            lambda qt, thl, qs, qlr, p, k: nudge.variability_nudge(
                qt, thl, qs, qlr, p, k, dt,
                constant_T=self.cfg.variability_nudge_constant_T))(
            jnp.asarray(fields["QT"]), jnp.asarray(fields["THL"]),
            jnp.asarray(fields["Qsat"]), conv.ql,
            jnp.asarray(prof["presf"]), keys)
        self.fleet.set_qt_thl(res.qt, res.thl)
        if write:
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col, qt_alpha=np.asarray(res.alpha[i]),
                    qt_beta=np.asarray(res.beta[i]),
                    qt_std=np.asarray(res.qt_std[i]))

    def _set_gcm_tendencies(self, conv, les_prof, dt, write):
        prof = self._last_gcm_prof
        A_d = np.asarray(self.fleet.cloud_fractions(np.asarray(conv.Zh)))
        jprof = {k: jnp.asarray(v, jnp.float32) for k, v in prof.items()}
        jles = {k: jnp.asarray(les_prof[k]) for k in
                ("U", "V", "THL", "QT", "QL", "QL_ice", "T", "Rhobf")}
        tend, diag = jax.vmap(
            lambda p, cv, lp, ad: convert.gcm_tendencies(
                p, cv, lp, ad, self._les_zf, self._les_zh_full, dt,
                factor=self.cfg.gcm_forcing_factor,
                conservative=self.cfg.conservative_coarsening))(
            jprof, conv, jles, jnp.asarray(A_d))

        if hasattr(self.gcm, "core"):  # native GCM: batched scatter
            cols = jnp.asarray(np.asarray(self.sp_cols, np.int32))
            self.gcm.state = self.gcm.core.with_sp_tendencies(
                self.gcm.state, cols, tend)
        else:
            for i, col in enumerate(self.sp_cols):
                for var in ("U", "V", "T", "SH", "QL", "QI", "A"):
                    self.gcm.set_profile_tendency(
                        var, col, np.asarray(tend[var][i]))

        if write:
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col,
                    u=les_prof["U"][i], v=les_prof["V"][i],
                    presf=les_prof["presf"][i], rhof=les_prof["Rhof"][i],
                    rhobf=les_prof["Rhobf"][i], qt=les_prof["QT"][i],
                    ql=les_prof["QL"][i], ql_ice=les_prof["QL_ice"][i],
                    ql_water=les_prof["QL_water"][i],
                    thl=les_prof["THL"][i], qr=les_prof["QR"][i],
                    t=np.asarray(diag["t"][i]), t_=les_prof["T"][i],
                    f_U=np.asarray(tend["U"][i]),
                    f_V=np.asarray(tend["V"][i]),
                    f_T=np.asarray(tend["T"][i]),
                    f_SH=np.asarray(tend["SH"][i]),
                    f_QL=np.asarray(tend["QL"][i]),
                    f_QI=np.asarray(tend["QI"][i]),
                    f_A=np.asarray(tend["A"][i]),
                    A=prof["A"][i], A_d=A_d[i],
                    Psurf=prof["Phalf"][i][-1])

    # -------------------------------------------------------------- stepping

    class _NullFile:
        def write(self, s):
            pass

        def flush(self):
            pass

        def close(self):
            pass

    def _open_timing(self):
        if self.timing_file is None:
            if not getattr(self, "io_proc", True):
                self.timing_file = self._NullFile()
                return
            self.timing_file = open(
                os.path.join(self.cfg.output_dir, "timing.txt"), "a")
            if not self.cfg.restart and not self._timing_header_done:
                self.timing_file.write(
                    "# LES grid points\n"
                    + " ".join(str(cix) for cix in self.sp_cols)
                    + "\n# timing data"
                    + " (fused path: phase cols zero except every"
                    " timing_phases-th step, where gcm_half1 col ="
                    " pre phase, gcm_half2 col = post phase, per-LES"
                    " cols = evolve; extra trailing col = host IO)\n")
                self._timing_header_done = True

    def _check_finite_profiles(self, profiles):
        """Failure detection on the generic (non-fused) path: same abort
        semantics as the fused path (reference: GCM step exception ->
        log + finalize + exit, splib.py:300-304)."""
        if not self.cfg.check_finite:
            return
        thl = np.asarray(profiles["THL"])
        if not np.all(np.isfinite(thl)):
            bad = [self.sp_cols[i] if i < len(self.sp_cols) else i
                   for i in np.where(~np.isfinite(thl).all(axis=-1))[0]]
            raise FloatingPointError(
                "non-finite LES state in column(s) %s" % bad)

    def _write_fused_diag(self, diag):
        """Write one fused-step diagnostics bundle to spifs.nc.

        `diag` is the PACKED flat device vector from the fused step (one
        device->host transfer); it is unpacked here."""
        d = self.coupled.unpack_diag(np.asarray(diag))
        if self.cfg.check_finite and not np.all(
                np.isfinite(d["les"]["THL"])):
            bad = [self.sp_cols[i] for i in np.where(
                ~np.isfinite(d["les"]["THL"]).all(axis=-1))[0]]
            raise FloatingPointError(
                "non-finite LES state in column(s) %s" % bad)
        n_sub = np.asarray(d["n_substeps"]).astype(int).tolist()
        log.info("LES substeps per column: %s", n_sub,
                 extra={"n_substeps": n_sub})
        ncl = np.asarray(d.get("n_dtmin_clamped", 0))
        if np.any(ncl > 0):
            bad = [self.sp_cols[i] for i in np.where(ncl > 0)[0]]
            log.warning("stability-required dt clamped at dt_min in "
                        "column(s) %s (%s substeps): LES near instability",
                        bad, ncl[ncl > 0])
        gcm, conv, les, tend, f = (d["gcm"], d["conv"], d["les"], d["tend"],
                                   d["forcing"])
        for i, col in enumerate(self.sp_cols):
            out = dict(
                U=gcm["U"][i], V=gcm["V"][i], T=gcm["T"][i],
                SH=gcm["SH"][i], QL=gcm["QL"][i], QI=gcm["QI"][i],
                Pf=gcm["Pfull"][i], Ph=gcm["Phalf"][i][1:],
                Zf=conv.Zf[i], Zh=conv.Zh[i][1:],
                Psurf=gcm["Phalf"][i][-1], Tv=conv.Tv[i],
                THL=conv.THL[i], QT=conv.QT[i],
                f_u=f["f_u"][i], f_v=f["f_v"][i], f_thl=f["f_thl"][i],
                f_qt=f["f_qt"][i],
                rain=d["rain"][i], rainrate=d["rainrate"][i] * 3600.0,
                u=les["U"][i], v=les["V"][i], presf=les["presf"][i],
                rhof=les["Rhof"][i], rhobf=les["Rhobf"][i],
                qt=les["QT"][i], ql=les["QL"][i], ql_ice=les["QL_ice"][i],
                ql_water=les["QL_water"][i], thl=les["THL"][i],
                qr=les["QR"][i], t=d["t_diag"][i], t_=les["T"][i],
                f_U=tend["U"][i], f_V=tend["V"][i], f_T=tend["T"][i],
                f_SH=tend["SH"][i], f_QL=tend["QL"][i],
                f_QI=tend["QI"][i], f_A=tend["A"][i],
                A=gcm["A"][i], A_d=d["A_d"][i],
            )
            if "qt_alpha" in d:
                out.update(qt_alpha=d["qt_alpha"][i],
                           qt_beta=d["qt_beta"][i], qt_std=d["qt_std"][i])
            if self.cfg.cplsurf and "surf" in d:
                out.update(z0m=d["z0m"][i], z0h=d["z0h"][i],
                           wthl=d["wthl"][i], wqt=d["wqt"][i],
                           TLflux=d["surf"]["TLflux"][i],
                           TSflux=d["surf"]["TSflux"][i],
                           SHflux=d["surf"]["SHflux"][i],
                           QLflux=d["surf"]["QLflux"][i],
                           QIflux=d["surf"]["QIflux"][i])
            self.writer.write_column(col, **out)
        self.rain_last = np.asarray(d["rain"])

    def _write_cross(self, t):
        """Per-instance cross-section record at the dtav cadence; the
        serialization runs on the native writer's worker thread, off the
        step loop."""
        if self.crossio is None or t + 1e-6 < self._cross_next:
            return
        fields = self.fleet.get_fields()
        self.crossio.write(self.fleet.state, fields["QL"], t)
        self._cross_next = t + max(self.cfg.les_cross_dtav, 1.0)

    def _flush_pending(self):
        """Drain the previous step's spifs record (write-behind).

        Called right after the next step's device program is dispatched,
        so the diag fetch + netCDF serialization overlap device compute
        (reference P4: sync_root runs while the LES fleet evolves,
        splib.py:573-574)."""
        p = getattr(self, "_pending_record", None)
        if p is None:
            return
        self._pending_record = None
        if p["time"] is not None:
            self.writer.update_time(p["time"])
        self._write_fused_diag(p["diag"])
        if p["outdata"]:
            for col, kwargs in p["outdata"]:
                self.writer.write_column(col, **kwargs)
        self.writer.sync()

    def _step_fused(self):
        """One coupled step through the fused jitted program."""
        cfg = self.cfg
        writecdf = (not (cfg.restart and self.firststep)
                    and self.step_index % max(cfg.write_every, 1) == 0)
        t = self.gcm.get_model_time()
        dt = self.gcm.get_timestep()
        start = time.time()
        skip = bool(getattr(self, "_half_step_done", False))
        self._half_step_done = False
        prev_prof = getattr(self, "_fused_prof", None)
        if prev_prof is None:
            prev_prof = self.fleet.get_profiles()
        # `first` follows the GCM's Euler-start bookkeeping (not the
        # coupling firststep flag: after a spinup the GCM is still on its
        # first leapfrog step while profiles already exist)
        #
        # Every cfg.timing_phases-th step runs through the SAME step split
        # into its pre/evolve/post programs with host barriers, restoring
        # the reference's per-phase timing columns (splib.py:340-343) at
        # that cadence with no duplicated compute. Deterministic on
        # step_index, so multi-controller processes stay in lockstep.
        n_ph = int(cfg.timing_phases or 0)
        phase_t = None
        if (n_ph > 0 and self.step_index > 0
                and self.step_index % n_ph == 0
                and self.coupled.evolve_chunks == 1):
            out, phase_t = self.coupled.call_phased(
                self.gcm.state, self.fleet.state, prev_prof,
                np.asarray(self.rain_last, np.float32),
                self.gcm.step_count, first=self.gcm._first,
                skip_half=skip)
        else:
            out = self.coupled(self.gcm.state, self.fleet.state, prev_prof,
                               np.asarray(self.rain_last, np.float32),
                               self.gcm.step_count, first=self.gcm._first,
                               skip_half=skip)  # async dispatch
        gcm_state, les_state, prof, rain, diag = out
        self.gcm.state = gcm_state
        self.gcm.step_count += 1
        self.gcm._first = False
        self.fleet.state = les_state
        self.fleet.time = float(t + dt)
        self._fused_prof = prof
        self.prev_profiles = None  # host copies are stale; refetch if needed
        for inst in self.instances:
            inst.invalidate_cache()
        # ---- write-behind: drain the PREVIOUS record while the device
        # executes this step
        io_wall = -time.time()
        self._flush_pending()
        io_wall += time.time()
        # ---- stash this step's record (flushed on the next step or at
        # finalize); output-column profiles are fetched now — they read
        # this step's post-step GCM state
        if writecdf:
            self._pending_record = dict(
                time=(None if self.firststep
                      else t + cfg.les_spinup + dt),
                diag=diag,
                outdata=self._output_columns_data())
            if not cfg.async_io:
                # synchronous IO mode: serialize this step's record now,
                # inside the step (write-behind disabled)
                io_wall -= time.time()
                self._flush_pending()
                io_wall += time.time()
        # sync this step for an honest per-step wall clock (rain is a
        # tiny replicated vector; fetching it forces completion)
        np.asarray(rain)
        self._write_cross(t + dt)
        step_wall = time.time() - start - max(io_wall, 0.0)
        n = max(len(self.sp_cols), 1)
        # fused path: on unsampled steps the reference's phase columns
        # (gcm1/gather/forcings/tendencies/gcm2) live inside ONE device
        # program -> zeros, per-LES columns carry the fused step wall split
        # evenly. Every cfg.timing_phases-th step ran as pre/evolve/post
        # with barriers: gcm_half1 column = pre (gcm1+gather+forcings),
        # gcm_half2 column = post (tendencies+gcm2), per-LES columns =
        # evolve split evenly. Host IO = extra trailing column.
        if phase_t is not None:
            t_pre, t_ev, t_post = phase_t
            line = ("%10.2f %6.2f %6.2f %6.2f %6.2f %6.2f " % (
                start, t_pre, 0.0, 0.0, 0.0, t_post)
                + " ".join("%6.2f" % (t_ev / n) for _ in self.sp_cols)
                + " %6.2f\n" % io_wall)
        else:
            line = ("%10.2f %6.2f %6.2f %6.2f %6.2f %6.2f " % (
                start, 0.0, 0.0, 0.0, 0.0, 0.0)
                + " ".join("%6.2f" % (step_wall / n) for _ in self.sp_cols)
                + " %6.2f\n" % io_wall)
        self.timing_file.write(line)
        self.timing_file.flush()
        self.firststep = False
        self.step_index += 1

    def lower_fused_step(self):
        """jax Lowered of the steady-state fused coupled step at the
        current state (after a run, its compile() is the executable the
        run used): .compile().memory_analysis() sizes it on the device."""
        return self.coupled.lower(
            self.gcm.state, self.fleet.state, self._fused_prof,
            np.asarray(self.rain_last, np.float32), self.gcm.step_count)

    def step(self):
        cfg = self.cfg
        self._open_timing()
        if self.coupled is not None:
            return self._step_fused()
        writecdf = (not (cfg.restart and self.firststep)
                    and self.step_index % max(cfg.write_every, 1) == 0)
        t = self.gcm.get_model_time()
        dt = self.gcm.get_timestep()

        start = time.time()
        tw1 = -time.time()
        if writecdf and not self.firststep:
            self.writer.update_time(t + cfg.les_spinup + dt)
        if getattr(self, "_half_step_done", False):
            self._half_step_done = False
        else:
            self.gcm.evolve_model_until_cloud_scheme()
            self.gcm.evolve_model_cloud_scheme()
        tw1 += time.time()

        if not self.sp_cols:
            # no superparameterized columns: GCM-only step + output columns
            if writecdf:
                self._write_output_columns()
            self.gcm.evolve_model_from_cloud_scheme()
            self.timing_file.write("%10.2f %6.2f\n" % (start,
                                                       time.time() - start))
            self.timing_file.flush()
            self.writer.sync()
            self.firststep = False
            return

        tw_gather = -time.time()
        conv = self._gather_convert(write=writecdf)
        tw_gather += time.time()

        tw_forc = -time.time()
        if self.firststep or self.prev_profiles is None:
            les_prof = self._les_profiles()
        else:
            les_prof = self.prev_profiles
        forcing = self._build_forcings(conv, les_prof, dt,
                                       cfg.les_forcing_factor, writecdf)
        if cfg.qt_forcing == "variance" and isinstance(
                self.fleet, les_model.LESFleet):
            self._variability_nudge(conv, dt, writecdf)
        tw_forc += time.time()

        tw_les = -time.time()
        self.fleet.evolve_to(t + dt, forcing)
        for inst in self.instances:
            inst.invalidate_cache()
        profiles = self._les_profiles()
        self.prev_profiles = profiles
        self._check_finite_profiles(profiles)
        if isinstance(self.fleet, les_model.LESFleet):
            self._write_cross(t + dt)
        tw_les += time.time()

        tw_tend = -time.time()
        self._set_gcm_tendencies(conv, profiles, dt, writecdf)
        tw_tend += time.time()

        tw2 = -time.time()
        self.gcm.evolve_model_from_cloud_scheme()
        tw2 += time.time()

        n = max(len(self.sp_cols), 1)
        line = ("%10.2f %6.2f %6.2f %6.2f %6.2f %6.2f " % (
            start, tw1, tw_gather, tw_forc, tw_tend, tw2)
            + " ".join("%6.2f" % (tw_les / n) for _ in self.sp_cols) + "\n")
        self.timing_file.write(line)
        self.timing_file.flush()
        self.writer.sync()
        self.firststep = False
        self.step_index += 1

    def run(self, nsteps):
        for s in range(nsteps):
            # profile the second step: past compile + Euler start
            # (reference tracing: per-step timing.txt; here additionally a
            # full device trace on request, SURVEY.md section 5)
            profiling = self.cfg.jax_profile and s == 1
            if profiling:
                tdir = os.path.join(self.cfg.output_dir, "jax_trace")
                jax.profiler.start_trace(tdir)
            self.step()
            if profiling:
                jax.profiler.stop_trace()
                log.info("jax profiler trace written to %s", tdir)
            log.info("---- time step %d done ----", s)
            self._log_memory()
            if (self.cfg.restart_steps > 0
                    and (s + 1) % self.cfg.restart_steps == 0):
                from ..io import restart as restart_io
                restart_io.save(self)

    @staticmethod
    def _log_memory():
        """Per-step host memory log (the reference logs psutil full-info
        after every step, splib.py:216, 225-226)."""
        try:
            import psutil
            rss = psutil.Process().memory_info().rss
        except Exception:
            try:
                with open("/proc/self/status") as f:
                    line = next(l for l in f if l.startswith("VmRSS"))
                rss = int(line.split()[1]) * 1024
            except Exception:
                return
        log.info("memory usage: %.1f MB rss", rss / 1e6)

    # ---------------------------------------------------------------- spinup

    def run_spinup(self, spinup_length, spinup_steps=1):
        """Nudge the LES fleet toward the (frozen) GCM state before t=0
        (splib.py:233-249, 355-401)."""
        self._open_timing()
        iter_len = spinup_length / spinup_steps
        for s in range(spinup_steps):
            if s == spinup_steps - 1:
                iter_len = spinup_length - (spinup_steps - 1) * iter_len
            if not self.firststep:
                self.writer.update_time(self.fleet.time + iter_len
                                        + self.cfg.les_spinup)
            conv = self._last_conv
            les_prof = (self._les_profiles() if self.firststep
                        else self.prev_profiles)
            forcing = self._build_forcings(
                conv, les_prof, iter_len,
                self.cfg.les_spinup_forcing_factor, True)
            self.fleet.evolve_to(self.fleet.time + iter_len, forcing)
            profiles = self._les_profiles()
            self.prev_profiles = profiles
            self._check_finite_profiles(profiles)
            for i, col in enumerate(self.sp_cols):
                self.writer.write_column(
                    col, u=profiles["U"][i], v=profiles["V"][i],
                    presf=profiles["presf"][i], qt=profiles["QT"][i],
                    ql=profiles["QL"][i], ql_ice=profiles["QL_ice"][i],
                    ql_water=profiles["QL_water"][i],
                    thl=profiles["THL"][i], t_=profiles["T"][i],
                    qr=profiles["QR"][i])
            self.firststep = False
        log.info("---- spinup done ----")

    # -------------------------------------------------------------- shutdown

    def finalize(self, save_restart=True):
        try:
            self._flush_pending()   # drain the write-behind record
        except Exception as e:
            log.error("pending spifs record flush failed: %s", e)
        if getattr(self, "crossio", None) is not None:
            try:
                self.crossio.close()
            except Exception as e:
                log.error("cross-section writer close failed: %s", e)
        if save_restart and self.fleet is not None:
            from ..io import restart as restart_io
            try:
                restart_io.save(self)
            except Exception as e:  # never lose the nc file over a restart
                log.error("restart save failed: %s", e)
        for m in [self.gcm, self.fleet]:
            if m is None:
                continue
            try:
                m.cleanup_code()
                m.stop()
            except Exception as e:
                log.error("exception while stopping model: %s", e)
        if self.writer is not None:
            self.writer.close()
        if self.timing_file is not None:
            self.timing_file.close()
            self.timing_file = None
        log.info("sp_coupler cleanup done")

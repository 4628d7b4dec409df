"""Fused coupled step: one jitted program per GCM step.

The reference's hot loop is a host-orchestrated chain of RPC batches
(SURVEY.md section 3.2). Here the whole chain — GCM phase A + cloud scheme,
column gather, profile conversion, forcing construction, optional
variability nudge, the full LES substep scan, slab reductions, tendency
remap + scatter, GCM phase B — compiles into a single XLA program. The
host touches device data once per step, asynchronously, to write spifs.nc.

Sharding: LES fleet state and all per-column arrays are constrained to the
``les`` mesh axis; the GCM state is replicated (small at T21..T255). XLA
inserts the gather/scatter collectives at the boundary.
"""

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import convert, nudge
from ..models.les import step as lstep, diag as ldiag
from ..models.les.state import LESForcing
from ..parallel import sharding as shd


class CoupledStepFn:
    """Compiled coupled step for a fixed configuration."""

    def __init__(self, gcm_core, les_grid, les_phys, sp_cols, dt_les,
                 n_substeps, les_forcing_factor=1.0, gcm_forcing_factor=1.0,
                 conservative=False, cplsurf=False, qt_variance=False,
                 constant_T=False, mesh=None, seed=42, evolve_chunks=1,
                 serial_evolve="auto", cfl=0.7, peclet=0.1, dt_min=0.2):
        self.core = gcm_core
        self.grid = les_grid
        self.phys = les_phys
        self.cols = jnp.asarray(sp_cols, jnp.int32)
        self.dt_les = float(dt_les)
        # n_substeps > 0: fixed-substep evolve (DALES ladaptive=.false.);
        # 0: CFL/Peclet-adaptive stepping with the targets below
        self.n_substeps = int(n_substeps)
        self.cfl = float(cfl)
        self.peclet = float(peclet)
        self.dt_min = float(dt_min)
        self.ffac = les_forcing_factor
        self.gfac = gcm_forcing_factor
        self.conservative = conservative
        self.cplsurf = cplsurf
        self.qt_variance = qt_variance
        self.constant_T = constant_T
        self.mesh = mesh
        self.seed = seed
        self.serial_evolve = serial_evolve  # "auto" | "serial" | "batched"
        # evolve_chunks > 1 splits one coupled step into pre / k x evolve /
        # post device programs: bounds single-execution device time for
        # very large fleets (preemption/checkpoint latency; some runtimes
        # also deadline long-running programs)
        self.evolve_chunks = max(1, int(evolve_chunks))
        self.zf = les_grid.zf()
        self.zh_full = les_grid.zh()
        self._jit = jax.jit(self._step,
                            static_argnames=("first", "skip_half"))
        self._jit_pre = jax.jit(self._pre,
                                static_argnames=("first", "skip_half"))
        self._jit_evolve = jax.jit(self._evolve_to)
        self._jit_post = jax.jit(self._post, static_argnames=("first",))

    def __call__(self, gcm_state, les_state, prev_prof, rain_last, step_idx,
                 first=False, skip_half=False):
        """skip_half: the GCM first half (phase A + cloud scheme) was already
        run host-side (the driver's initialization does it before seeding
        the LES states, mirroring splib.py:183-189)."""
        if self.evolve_chunks > 1:
            return self._call_chunked(gcm_state, les_state, prev_prof,
                                      rain_last, step_idx, first, skip_half)
        return self._jit(self.core.consts(), gcm_state, les_state,
                         prev_prof, rain_last,
                         jnp.asarray(step_idx, jnp.int32), first=first,
                         skip_half=skip_half)

    def lower(self, gcm_state, les_state, prev_prof, rain_last, step_idx,
              first=False, skip_half=False):
        """The fused step's jax ``Lowered`` for these inputs; its
        ``compile()`` gives memory_analysis() / cost_analysis(), and after
        a call with the same shapes it is the executable already built."""
        return self._jit.lower(self.core.consts(), gcm_state, les_state,
                               prev_prof, rain_last,
                               jnp.asarray(step_idx, jnp.int32), first=first,
                               skip_half=skip_half)

    def _call_chunked(self, gcm_state, les_state, prev_prof, rain_last,
                      step_idx, first, skip_half):
        dt = self.core.cfg.dt
        gcm_state, les_state, forcing, conv, prof, pre_diag = self._jit_pre(
            self.core.consts(), gcm_state, les_state, prev_prof,
            jnp.asarray(step_idx, jnp.int32), first=first,
            skip_half=skip_half)
        n_sub = jnp.zeros((self.cols.shape[0],), jnp.int32)
        n_clamp = jnp.zeros((self.cols.shape[0],), jnp.int32)
        k = self.evolve_chunks
        for _ in range(k):
            les_state, ns, nc = self._jit_evolve(les_state, forcing, dt / k)
            n_sub = n_sub + ns
            n_clamp = n_clamp + nc
        return self._jit_post(self.core.consts(), gcm_state, les_state,
                              conv, prof, rain_last, n_sub, n_clamp,
                              pre_diag, first=first)

    def call_phased(self, gcm_state, les_state, prev_prof, rain_last,
                    step_idx, first=False, skip_half=False):
        """One coupled step through the pre / evolve / post programs with a
        host barrier after each: returns (out, (t_pre, t_ev, t_post)).

        Same math as the fused program (``_step`` is exactly
        pre+evolve+post), so the outputs ARE the production trajectory —
        the driver routes every N-th step through here to regain the
        reference's per-phase timing.txt columns (splib.py:340-343)
        without duplicating any compute."""
        import time as _time
        cst = self.core.consts()
        sidx = jnp.asarray(step_idx, jnp.int32)
        t0 = _time.time()
        pre = jax.block_until_ready(self._jit_pre(
            cst, gcm_state, les_state, prev_prof, sidx, first=first,
            skip_half=skip_half))
        t_pre = _time.time() - t0
        gcm_state, les_state, forcing, conv, prof, pre_diag = pre
        t0 = _time.time()
        les_state, n_sub, n_clamp = jax.block_until_ready(
            self._jit_evolve(les_state, forcing, self.core.cfg.dt))
        t_ev = _time.time() - t0
        t0 = _time.time()
        out = jax.block_until_ready(self._jit_post(
            cst, gcm_state, les_state, conv, prof,
            jnp.asarray(rain_last, jnp.float32), n_sub, n_clamp,
            pre_diag, first=first))
        t_post = _time.time() - t0
        return out, (t_pre, t_ev, t_post)

    # ------------------------------------------------------------------

    def _les_profiles(self, les_state):
        return jax.vmap(lambda s: ldiag.slab_profiles(self.grid, s))(
            les_state)

    def _pre(self, cst, gcm_state, les_state, prev_prof, step_idx, first,
             skip_half=False):
        """GCM first half + gather/convert/forcings (+ nudge).

        ``cst``: the GCM's big spectral tables, threaded as jit arguments
        (GCMCore.consts — closure constants of this size break remote
        compiles at high truncation); bound around the phase bodies."""
        core = self.core
        dt = core.cfg.dt

        # --- GCM first half (phase A + cloud scheme) ---
        if not skip_half:
            with core.bound(cst):
                gcm_state = core._phase_a_body(gcm_state, first)
            gcm_state = core.phase_cloud(gcm_state)

        # --- gather + convert SP columns ---
        prof = core.column_profiles(gcm_state, self.cols)      # [n, L]
        prof = shd.constrain_columns(prof, self.mesh)
        conv = jax.vmap(lambda p: convert.convert_profiles(p, self.zf))(prof)

        les_prof = self._les_profiles(les_state) if first else prev_prof

        # --- forcings ---
        fdict = jax.vmap(lambda cv, lp: convert.les_forcings(
            cv, lp, dt, self.ffac))(
            conv, {k: les_prof[k] for k in
                   ("U", "V", "THL", "QT", "QL", "PS")})
        rain = les_prof["Rain"]

        n = self.cols.shape[0]
        if self.cplsurf:
            surf = core.surface_fields(gcm_state, self.cols)
            z0m, z0h, wthl, wqt = convert.convert_surface_fluxes(
                surf, prof["Phalf"][:, -1], prof["T"][:, -1])
        else:
            surf = None
            z0m = jnp.full((n,), 0.1)
            z0h = jnp.full((n,), 0.02)
            wthl = jnp.zeros((n,))
            wqt = jnp.zeros((n,))

        forcing = LESForcing(
            f_u=fdict["f_u"], f_v=fdict["f_v"], f_thl=fdict["f_thl"],
            f_qt=fdict["f_qt"], f_ql=fdict["f_ql"], f_ps=fdict["f_ps"],
            ql_ref=conv.ql, wthl=wthl, wqt=wqt, z0m=z0m, z0h=z0h)

        pre_diag = {"gcm": prof, "forcing": fdict, "rain": rain,
                    "z0m": z0m, "z0h": z0h, "wthl": wthl, "wqt": wqt}
        if surf is not None:
            pre_diag["surf"] = surf

        if self.qt_variance:
            fields = jax.vmap(ldiag.fields_3d)(les_state)
            key = jax.random.fold_in(jax.random.PRNGKey(self.seed + 1),
                                     step_idx)
            keys = jax.random.split(key, n)
            res = jax.vmap(lambda qt, thl, qs, qlr, p, k:
                           nudge.variability_nudge(
                               qt, thl, qs, qlr, p, k, dt,
                               constant_T=self.constant_T))(
                fields["QT"], fields["THL"], fields["Qsat"], conv.ql,
                les_state.pbf, keys)
            apply_nudge = jnp.logical_not(jnp.asarray(first))
            qt_new = jnp.where(apply_nudge, res.qt, les_state.qt)
            thl_new = jnp.where(apply_nudge, res.thl, les_state.thl)
            les_state = les_state._replace(qt=qt_new, thl=thl_new)
            # diagnostics zeroed when the nudge is not applied (first
            # step), matching the generic path which skips the nudge
            # entirely there (driver._variability_nudge: fleet.time <= 0)
            mask = lambda x: jnp.where(apply_nudge, x, jnp.zeros_like(x))
            pre_diag.update(qt_alpha=mask(res.alpha),
                            qt_beta=mask(res.beta),
                            qt_std=mask(res.qt_std))
        return gcm_state, les_state, forcing, conv, prof, pre_diag

    def _evolve_to(self, les_state, forcing, dt_frac):
        """LES fleet evolve by dt_frac seconds (the hot loop).

        With a pure instance-parallel mesh (les axis only) the evolve runs
        under shard_map: each device's adaptive while_loop stops when ITS
        local instances reach t_end. Under plain GSPMD the loop condition
        is a global any(), so every device would pace at the slowest
        instance on the whole mesh — stragglers would serialize the fleet.

        Within one device, big instances run SERIALLY (lax.map), each
        with its own adaptive loop: device work is sum_i(n_substeps_i)
        instead of the batched loop's n * max_i(n_substeps_i) — the
        reference's instances are fully independent (splib.py:554-593).
        """
        if self.n_substeps > 0:
            nn = max(1, int(round(self.n_substeps * dt_frac
                                  / self.core.cfg.dt)))

            def one(s, f):
                s = lstep.evolve(self.grid, self.phys, s, f,
                                 dt_frac / nn, nn)
                z = jnp.zeros((), jnp.int32)
                return s, z + nn, z
        else:
            one = lambda s, f: lstep.evolve_adaptive(
                self.grid, self.phys, s, f, s.time + dt_frac,
                dt_max=self.dt_les, cfl=self.cfl, peclet=self.peclet,
                dt_min=self.dt_min)
        serial = (lstep.serial_fleet_default(self.grid)
                  if self.serial_evolve == "auto"
                  else self.serial_evolve == "serial")
        evolve = lambda st, f: lstep.map_fleet(one, st, f, serial)
        mesh = self.mesh
        les_state = shd.constrain_fleet(les_state, mesh)
        if mesh is not None and not shd.spatial_axes(mesh):
            from jax.sharding import PartitionSpec as P
            spec = jax.tree.map(
                lambda x: P("les") if getattr(x, "ndim", 0) >= 1 else P(),
                (les_state, forcing))
            les_state, n_sub, n_clamp = jax.shard_map(
                evolve, mesh=mesh, in_specs=spec,
                out_specs=(spec[0], P("les"), P("les")))(les_state, forcing)
        else:
            les_state, n_sub, n_clamp = evolve(les_state, forcing)
        les_state = shd.constrain_fleet(les_state, mesh)
        return les_state, n_sub, n_clamp

    def _post(self, cst, gcm_state, les_state, conv, prof, rain_last,
              n_sub, n_clamp, pre_diag, first):
        """Slab diagnostics, LES -> GCM tendencies, GCM second half."""
        core, grid = self.core, self.grid
        dt = core.cfg.dt
        prof_les = self._les_profiles(les_state)

        A_d = jax.vmap(lambda cf, Zh: ldiag.cloud_fraction_on_gcm_levels(
            grid, cf, Zh))(prof_les["cloudfrac_z"], conv.Zh)
        jles = {k: prof_les[k] for k in
                ("U", "V", "THL", "QT", "QL", "QL_ice", "T", "Rhobf")}
        tend, tdiag = jax.vmap(
            lambda p, cv, lp, ad: convert.gcm_tendencies(
                p, cv, lp, ad, self.zf, self.zh_full, dt,
                factor=self.gfac, conservative=self.conservative))(
            prof, conv, jles, A_d)
        gcm_state = core.with_sp_tendencies(gcm_state, self.cols, tend)

        # --- GCM second half ---
        with core.bound(cst):
            gcm_state = core._phase_b_body(gcm_state, first)

        rain = pre_diag["rain"]
        diag = dict(pre_diag)
        diag.update(
            conv=conv, rainrate=(rain - rain_last) / dt,
            les=prof_les, tend=tend, t_diag=tdiag["t"],
            A_d=A_d, n_substeps=n_sub, n_dtmin_clamped=n_clamp)
        # Diagnostics and the prev-step profile carry are small [n, L]
        # arrays; replicate them so that in a multi-controller run every
        # process holds a fully-addressable copy (the host-side spifs
        # writer fetches them with np.asarray, driver._write_fused_diag).
        # XLA turns this into one tiny all-gather over the les axis.
        # The diag bundle is PACKED into one flat f32 vector: the host
        # fetches it with a single device->host transfer instead of ~50
        # per-leaf transfers.
        diag = self._pack_diag(diag)
        prof_les, rain, diag = shd.replicated(
            (prof_les, rain, diag), self.mesh)
        return gcm_state, les_state, prof_les, rain, diag

    def _pack_diag(self, diag):
        """Flatten the diag pytree into one f32 vector; record the spec."""
        leaves, treedef = jax.tree.flatten(diag)
        self._diag_spec = (treedef,
                           [l.shape for l in leaves],
                           [l.dtype for l in leaves])
        return jnp.concatenate(
            [l.astype(jnp.float32).ravel() for l in leaves])

    def unpack_diag(self, flat):
        """Host-side inverse of _pack_diag (flat: numpy f32 vector)."""
        import numpy as np
        treedef, shapes, dtypes = self._diag_spec
        out, off = [], 0
        for shp, dt in zip(shapes, dtypes):
            n = int(np.prod(shp)) if shp else 1
            out.append(np.asarray(flat[off:off + n]).reshape(shp)
                       .astype(dt))
            off += n
        return jax.tree.unflatten(treedef, out)

    def _step(self, cst, gcm_state, les_state, prev_prof, rain_last,
              step_idx, first, skip_half=False):
        gcm_state, les_state, forcing, conv, prof, pre_diag = self._pre(
            cst, gcm_state, les_state, prev_prof, step_idx, first,
            skip_half)
        les_state, n_sub, n_clamp = self._evolve_to(les_state, forcing,
                                                    self.core.cfg.dt)
        return self._post(cst, gcm_state, les_state, conv, prof, rain_last,
                          n_sub, n_clamp, pre_diag, first)

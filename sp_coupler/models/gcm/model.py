"""GCM model: phase-split stepping + the column API the coupler consumes.

Reproduces the OpenIFS surface consumed by the reference coupler
(SURVEY.md section 2.2): the three-phase timestep split at the cloud scheme,
the per-column SP mask, batched profile getters (U, V, T, SH, QL, QI,
Pfull, Phalf, A, Zgfull, Zghalf), surface-field getters, and accepted
external profile tendencies for U, V, T, SH, QL, QI, A
(splib.py:186-188, 296-299, 335, 472-480; spcpl.py:32-33, 62-75, 535-542).

The compute core is functional and jitted: GCMModel is a thin host-side
shell holding the device-resident state pytree; the fused coupled step
(coupling/coupler.py) calls the phase functions directly on device.
"""

import contextlib
import dataclasses
import datetime
import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ... import constants as c
from ...utils import thermo
from . import spharm, vertical, dycore, physics


class GCMState(NamedTuple):
    """Device-resident GCM state between phases."""

    now: dycore.SpectralState       # filtered state at t
    prev: dycore.SpectralState      # filtered state at t - dt
    new: dycore.SpectralState       # provisional state at t + dt (mid-phase)
    grid: dycore.GridFields         # grid view of `new` (valid after phase A)
    sfc: dict                       # surface flux fields (valid after phase A)
    sp_tend: dict                   # dense SP tendency maps [L, nlat, nlon]
    vdiff_mask: jnp.ndarray         # [nlat, nlon] 1 = vdiff active
    time: jnp.ndarray               # model time (s)


def _zero_sp_tend(dtype=jnp.float32):
    """Cleared SP tendencies as SCALAR zeros.

    Broadcasting makes a scalar 0 equivalent to a dense zero map in
    phase B; storing scalars keeps the idle buffers off HBM (7 dense
    [L, nlat, nlon] maps are ~1.4 GB at TL639/L60). with_sp_tendencies
    densifies on first scatter.
    """
    z = jnp.zeros((), dtype)
    return {k: z for k in ("U", "V", "T", "SH", "QL", "QI", "A")}


@dataclasses.dataclass(frozen=True)
class GCMConfig:
    trunc: int = 21
    nlev: int = 19
    dt: float = 900.0
    tref: float = 300.0
    start_date: str = "2000-01-01T00:00:00"
    diffusion_tau: float = 4.0 * 3600.0
    robert_eps: float = 0.05
    hybrid: bool = False    # hybrid sigma-p A/B levels (OpenIFS-like);
                            # False = pure sigma (round-1 behavior)
    advection: str = "eulerian"  # "eulerian" (flux-form leapfrog; stable
                                 # up to the advective CFL) | "sl" (3TL
                                 # semi-Lagrangian, semilag.py — the
                                 # OpenIFS-lineage large-timestep scheme
                                 # required at high truncation)
    sl_decenter: float = 0.1     # SL-SI off-centering epsilon (damps the
                                 # spurious 3TL resonance; semilag.sl_step)
    sl_coriolis: str = "auto"    # "midpoint" (centered explicit, the
                                 # IFS-lineage default; stable for
                                 # f tau < 2) | "trapezoid" (departure/
                                 # arrival split; stable for any f dt
                                 # but damps synoptic eddies — see
                                 # semilag.sl_step) | "auto" (midpoint
                                 # unless the polar f tau approaches
                                 # the midpoint bound)
    split_phases: bool = False   # run phase A's dynamics and physics as
                                 # separate device programs (low-memory
                                 # mode for TL639-class truncations)
    phys: physics.PhysicsParams = physics.PhysicsParams()


class GCMCore:
    """Functional core: precomputed operators + jitted phase functions.

    ``mesh``/``shard_axis`` lay the Gaussian grid out in latitude bands
    over the named mesh axis (or tuple of axes) — the reference's
    intra-GCM parallelism (P3, --gcmprocs / OpenIFS NPROC). GCM and LES
    phases never overlap in time, so the GCM reuses the LES fleet's
    devices (SURVEY.md section 2.4).
    """

    def __init__(self, cfg: GCMConfig, mesh=None, shard_axis=None):
        if cfg.advection not in ("eulerian", "sl"):
            raise ValueError("GCMConfig.advection must be 'eulerian' or "
                             "'sl', got %r" % (cfg.advection,))
        if cfg.sl_coriolis not in ("auto", "midpoint", "trapezoid"):
            raise ValueError("GCMConfig.sl_coriolis must be 'auto', "
                             "'midpoint' or 'trapezoid', got %r"
                             % (cfg.sl_coriolis,))
        self.cfg = cfg
        self.sht = spharm.SpectralTransform(cfg.trunc, mesh=mesh,
                                            axis=shard_axis)
        self.vc = vertical.VerticalCoords(cfg.nlev, tref=cfg.tref,
                                          hybrid=cfg.hybrid)
        self.slg = None
        self.sl_cor = cfg.sl_coriolis
        if self.sl_cor == "auto":
            # polar f tau = 2 Omega * 2 dt; the centered-midpoint form is
            # stable below 2 — switch to the unconditionally-stable (but
            # eddy-damping) trapezoid with a stability margin
            self.sl_cor = ("trapezoid"
                           if 2.0 * c.omega * 2.0 * cfg.dt > 1.5
                           else "midpoint")
        if cfg.advection == "sl":
            from . import semilag
            # dt sizes the latitude-banded interpolation windows for the
            # 150 m/s design wind at every latitude (semilag.SLGrid)
            self.slg = semilag.SLGrid(self.sht, dt=cfg.dt)
            if cfg.split_phases:
                # level-chunk the window interpolation (low-memory mode):
                # largest divisor of nlev <= 4 — the interp body's HLO
                # temp measured ~2.9 GB + 0.5 GB/level at TL639, and the
                # steady-state step must leave room for two distinct
                # spectral states + the trajectory angles
                self.slg.k_chunk = next(
                    (kc for kc in range(min(4, cfg.nlev), 0, -1)
                     if cfg.nlev % kc == 0), None)
        # warm the implicit-inverse caches (host-side numpy inversions)
        self.vc.implicit_inverse(cfg.dt / 2.0, cfg.trunc)
        self.vc.implicit_inverse(cfg.dt / 4.0, cfg.trunc)
        self.vc.implicit_inverse(cfg.dt, cfg.trunc)
        if cfg.advection == "sl":
            # SL-SI off-centered arrival weights (semilag.sl_step)
            eps = cfg.sl_decenter
            self.vc.implicit_inverse((1.0 + eps) * cfg.dt / 2.0, cfg.trunc)
            self.vc.implicit_inverse((1.0 + eps) * cfg.dt, cfg.trunc)
        mu = np.asarray(self.sht.mu)
        self.lat_rad = jnp.asarray(np.arcsin(mu), jnp.float32)[:, None]
        self.fcor = jnp.asarray(2 * c.omega * mu, jnp.float32)[:, None]
        self.nlat, self.nlon = self.sht.nlat, self.sht.nlon
        self.ncols = self.nlat * self.nlon
        # In split-phase (low-memory) mode the host-stepping jits DONATE
        # the incoming state so XLA reuses its buffers for the outputs —
        # without donation the old and new 4-7 GB states are co-resident
        # at TL639 and the 16 GB chip OOMs. Contract: in split mode the
        # caller must not touch a state after passing it to a phase.
        don = cfg.split_phases
        self._phase_a_phys_jit = jax.jit(
            self._phase_a_phys_cst, donate_argnums=(1, 2) if don else ())
        self._phase_cloud_jit = jax.jit(
            self._phase_cloud_cst, donate_argnums=(0,) if don else ())
        self._phase_b_jit = jax.jit(
            self._phase_b_cst, static_argnums=(2,),
            donate_argnums=(1,) if don else ())
        self._apply_don_jit = jax.jit(
            self._apply_cst, static_argnums=(1,), donate_argnums=(2,))
        if don and cfg.advection == "sl":
            # split the SL dynamics itself into trajectories -> dep-stack
            # -> dep-interp -> prep-mid -> finish programs: fused, the
            # HLO temporaries exceed the 16 GB chip at TL639/L60 (see
            # semilag.sl_trajectories docstring)
            self._sl_traj_jit = jax.jit(self._sl_traj_cst,
                                        static_argnums=(2,))
            self._sl_stack_jit = jax.jit(self._sl_stack_cst,
                                         static_argnums=(3,))
            self._sl_mid_grid_jit = jax.jit(self._sl_mid_grid_cst)
            self._sl_mid_terms_jit = jax.jit(self._sl_mid_terms_cst,
                                             donate_argnums=(2,))
            self._sl_dep_jit = jax.jit(self._sl_dep_cst,
                                       donate_argnums=(1, 2, 3, 4, 5, 6))
            self._sl_arr_jit = jax.jit(
                self._sl_arr_cst, static_argnums=(9,),
                donate_argnums=(1, 2, 3, 4, 5, 6, 7, 8))
            # NO donation on the solve program: its working set is the
            # smallest of the pipeline (6.9 GB total at TL639/L60), and
            # its donated-input variant failed to run (first=False) on
            # the accelerator this mode was written for
            self._sl_solve_jit = jax.jit(
                self._sl_solve_cst, static_argnums=(9,))

    # ---- constant threading -------------------------------------------
    # The spectral tables are threaded through every jitted phase as
    # ARGUMENTS (spharm.consts/bound): closure-captured tables are
    # serialized into the lowered module, which at TL639 (~0.5 GB) breaks
    # the remote-compile transport. `apply` runs any module-level
    # function under jit with the tables bound the same way.

    def consts(self):
        cst = {"sht": self.sht.consts()}
        if self.slg is not None:
            cst["slg"] = self.slg.consts()
        return cst

    @contextlib.contextmanager
    def bound(self, cst):
        with contextlib.ExitStack() as st:
            st.enter_context(self.sht.bound(cst.get("sht", {})))
            if self.slg is not None:
                st.enter_context(self.slg.bound(cst.get("slg", {})))
            yield

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def _apply_jit(self, cst, fn, *args):
        with self.bound(cst):
            return fn(self, *args)

    def _apply_cst(self, cst, fn, *args):
        with self.bound(cst):
            return fn(self, *args)

    def apply(self, fn, *args, donate_first=False):
        """jit-run fn(core, *args) with the big tables passed as jit
        arguments (fn must be a module-level, hashable function).
        donate_first=True donates args[0] (a state being functionally
        replaced) so its buffers are reused — the caller must drop its
        reference."""
        if donate_first:
            return self._apply_don_jit(self.consts(), fn, *args)
        return self._apply_jit(self.consts(), fn, *args)

    # ---- initial condition -------------------------------------------------

    def initial_state(self, seed=0) -> GCMState:
        """Jit-compiled initial state (one program instead of slow eager
        op-by-op dispatch)."""
        return self._initial_jit(self.consts(), seed)

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def _initial_jit(self, cst, seed):
        with self.bound(cst):
            return self._initial_state(seed)

    def _initial_state(self, seed=0) -> GCMState:
        sht, vc, cfg = self.sht, self.vc, self.cfg
        L, M, N = cfg.nlev, sht.M, sht.N
        ps = jnp.asarray(c.pref0)
        _, p_full = vc.pressures(ps)
        p_full = p_full[:, None, None]
        Teq = physics.equilibrium_temperature(p_full, self.lat_rad,
                                              cfg.phys)
        T_grid = jnp.broadcast_to(Teq, (L, self.nlat, self.nlon))
        # relative humidity decays with height (~80% at the surface, ~40%
        # at 600 hPa), the observed tropical-marine structure; constant-RH
        # moisture makes the whole column moist-unstable and drives the
        # embedded LES into deep convection instead of trade cumulus
        rh = 0.8 * vc.sf[:, None, None] ** 1.5
        q_grid = rh * thermo.qsat_liq(T_grid, p_full)
        spec = dycore.SpectralState.zeros(L, M, N)
        spec = spec._replace(
            T=sht.analyze(T_grid),
            q=sht.analyze(q_grid),
        )
        # small rotational perturbation to break zonal symmetry
        key = jax.random.PRNGKey(seed)
        pert = 1e-6 * jax.random.normal(key, (L, M, N, 2))
        keep = ((jnp.arange(N)[None, :, None] < 8)
                & (jnp.arange(M)[:, None, None] < 8))
        spec = spec._replace(vort=(spec.vort + pert * keep)
                             * self.sht.mask[..., None])
        grid = dycore.to_grid(sht, vc, spec)
        sfc = self._surface(grid)
        return GCMState(
            now=spec, prev=spec, new=spec, grid=grid, sfc=sfc,
            sp_tend=_zero_sp_tend(),
            vdiff_mask=jnp.ones((self.nlat, self.nlon), jnp.float32),
            time=jnp.zeros((), jnp.float32),
        )

    # ---- helpers -----------------------------------------------------------

    def _surface(self, grid):
        ps = c.pref0 * jnp.exp(grid.lnps)
        _, pf = self.vc.pressures(ps)
        z1 = c.rd * grid.T[-1] / c.grav * (1.0 - pf[-1] / ps) * 2.0
        z1 = jnp.maximum(z1, 10.0)
        return physics.surface_fluxes(grid.u[-1], grid.v[-1], grid.T[-1],
                                      grid.q[-1], ps, z1, self.lat_rad,
                                      self.cfg.phys)

    def _layer_depths(self, grid):
        """dz of each layer [L, nlat, nlon] from hydrostatics."""
        ps = c.pref0 * jnp.exp(grid.lnps)
        ph, pf = self.vc.pressures(ps)
        dp = ph[1:] - ph[:-1]
        rho = pf / (c.rd * jnp.maximum(grid.T, 100.0))
        return dp / (rho * c.grav)

    # ---- phases ------------------------------------------------------------

    @staticmethod
    def _tight_sync(x):
        """Tiny fetch that serializes the async dispatch queue.

        In split mode every enqueued program's arguments AND outputs are
        resident at once; at TL639 three multi-GB programs in flight
        exceeded the 16 GB device this mode was written for. A scalar
        fetch after each dispatch bounds residency to one program's
        working set."""
        leaf = jax.tree_util.tree_leaves(x)[0]
        np.asarray(leaf[(0,) * leaf.ndim])

    def phase_a(self, state: GCMState, first: bool = False) -> GCMState:
        if self.cfg.split_phases:
            # low-memory mode for very high truncation (TL639 on a 16 GB
            # chip): the dynamics and physics halves run as SEPARATE
            # device programs so their temporaries are not co-resident —
            # and the SL dynamics itself splits again into prep (stack
            # construction) and solve (interpolation + SI) programs
            if self.slg is not None:
                cst = self.consts()
                # ORDER MATTERS for peak HBM: the midpoint prep (split
                # again into grid-view + N-term programs; fused its HLO
                # temp is 8.5 GB at TL639/L60, scripts/tl639_mem.py)
                # runs FIRST, while only the now/prev spectral states
                # are live; the later programs tolerate the mid stack
                # (1.6 GB) riding along.
                mg = self._sl_mid_grid_jit(cst, state.now)
                self._tight_sync(mg["sdot"])
                mid = self._sl_mid_terms_jit(cst, state.now, mg)
                del mg                     # donated to the terms program
                self._tight_sync(mid["N_pi"])
                traj = self._sl_traj_jit(cst, state.now, first)
                self._tight_sync(traj["angm"][0])
                stack = self._sl_stack_jit(cst, state.now, state.prev,
                                           first)
                self._tight_sync(stack["pi_comb"])
                angm = traj["angm"]
                dep_vals, pi_dep = self._sl_dep_jit(
                    cst, stack["dep"], stack["pi_comb"], *traj["angd"])
                del stack, traj              # donated to the dep program
                self._tight_sync(pi_dep)
                arr = self._sl_arr_jit(cst, mid["mid"], mid["N_pi"],
                                       *angm, dep_vals, pi_dep, first)
                del mid, angm, dep_vals, pi_dep
                self._tight_sync(arr[0])
                new = self._sl_solve_jit(cst, *arr, first)
                del arr
            else:
                new = self._phase_a_dyn_jit(self.consts(), state, first)
            self._tight_sync(new.vort)
            return self._phase_a_phys_jit(self.consts(), state, new)
        return self._phase_a_jit(self.consts(), state, first)

    def _sl_traj_cst(self, cst, now, first):
        from . import semilag
        with self.bound(cst):
            dt2 = self.cfg.dt if first else 2.0 * self.cfg.dt
            return semilag.sl_trajectories(self.sht, self.vc, self.slg,
                                           now, dt2)

    def _sl_stack_cst(self, cst, now, prev, first):
        from . import semilag
        with self.bound(cst):
            dt2 = self.cfg.dt if first else 2.0 * self.cfg.dt
            return semilag.sl_dep_stack(self.sht, self.vc, self.slg, now,
                                        prev, dt2,
                                        decenter=self.cfg.sl_decenter,
                                        coriolis=self.sl_cor)

    def _sl_mid_grid_cst(self, cst, now):
        from . import semilag
        with self.bound(cst):
            return semilag.sl_mid_grid(self.sht, self.vc, self.slg, now)

    def _sl_mid_terms_cst(self, cst, now, mg):
        from . import semilag
        with self.bound(cst):
            return semilag.sl_mid_terms(self.sht, self.vc, self.slg, now,
                                        mg, coriolis=self.sl_cor)

    def _sl_dep_cst(self, cst, dep, pi_comb, lam_d, phi_d, lam_d2, phi_d2):
        from . import semilag
        with self.bound(cst):
            # blocked output: sl_arrivals consumes the level blocks
            # natively, skipping a ~1.5 GB de-blocking transpose at
            # TL639/L60 on each side
            return semilag.sl_interp_dep(self.slg, dep, pi_comb,
                                         lam_d, phi_d, lam_d2, phi_d2,
                                         blocks=True)

    def _sl_arr_cst(self, cst, mid, N_pi, lam_m, phi_m, lam_m2, phi_m2,
                    dep_vals, pi_dep, first):
        from . import semilag
        with self.bound(cst):
            dt2 = self.cfg.dt if first else 2.0 * self.cfg.dt
            return semilag.sl_arrivals(self.slg, mid, N_pi, lam_m, phi_m,
                                       lam_m2, phi_m2, dep_vals, pi_dep,
                                       dt2, coriolis=self.sl_cor)

    def _sl_solve_cst(self, cst, u_t, v_t, T_t, q_t, ql_t, qi_t, a_t,
                      pi_t, first):
        from . import semilag
        with self.bound(cst):
            cfg = self.cfg
            dt2 = cfg.dt if first else 2.0 * cfg.dt
            new = semilag.sl_solve(self.sht, self.vc, u_t, v_t, T_t, q_t,
                                   ql_t, qi_t, a_t, pi_t, dt2,
                                   decenter=cfg.sl_decenter)
            return dycore.hyperdiffuse(self.sht, new, cfg.dt,
                                       cfg.diffusion_tau, damp_lnps=True)

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _phase_a_jit(self, cst, state, first):
        with self.bound(cst):
            return self._phase_a_body(state, first)

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def _phase_a_dyn_jit(self, cst, state, first):
        with self.bound(cst):
            return self._phase_a_dyn(state, first)

    def _phase_a_phys_cst(self, cst, state, new):
        with self.bound(cst):
            return self._phase_a_phys(state, new)

    def _phase_a_dyn(self, state: GCMState, first: bool):
        """Dynamics half of phase A: advance the spectral state over the
        leapfrog window + hyperdiffusion. Returns the provisional `new`."""
        cfg, sht, vc = self.cfg, self.sht, self.vc
        dt2 = cfg.dt if first else 2.0 * cfg.dt
        if self.slg is not None:
            from . import semilag
            new = semilag.sl_step(sht, vc, self.slg, state.now,
                                  state.prev, dt2,
                                  decenter=cfg.sl_decenter,
                                  coriolis=self.sl_cor)
        else:
            N, _ = dycore.tendencies(sht, vc, state.now, self.fcor)
            new = dycore.semi_implicit_step(sht, vc, state.now, state.prev,
                                            N, dt2)
        return dycore.hyperdiffuse(sht, new, cfg.dt, cfg.diffusion_tau,
                                   damp_lnps=self.slg is not None)

    def _phase_a_body(self, state: GCMState, first: bool = False) -> GCMState:
        """Dynamics step + pre-cloud physics (radiation, vdiff).

        evolve_model_until_cloud_scheme equivalent; model time unchanged.
        ``first`` (static) selects the Euler start (dt window) over the
        regular leapfrog window (2 dt).
        """
        return self._phase_a_phys(state, self._phase_a_dyn(state, first))

    def _phase_a_phys(self, state: GCMState, new) -> GCMState:
        """Physics half of phase A on the provisional spectral state."""
        cfg, sht, vc = self.cfg, self.sht, self.vc
        grid = dycore.to_grid(sht, vc, new)
        sfc = self._surface(grid)
        # physics adjustments on the provisional state
        _, p_full = self.vc.pressures(c.pref0 * jnp.exp(grid.lnps))
        dT_rad = physics.radiation(grid.T, p_full, self.lat_rad, vc.sf,
                                   cfg.phys)
        dz = self._layer_depths(grid)
        du, dv, dT_vd, dq_vd = physics.vertical_diffusion(
            vc, grid.u, grid.v, grid.T, grid.q, sfc, dz, cfg.phys,
            state.vdiff_mask)
        if cfg.phys.rayleigh_tau > 0.0:
            # HS94 boundary-layer Rayleigh friction (benchmark config)
            kf = (1.0 / cfg.phys.rayleigh_tau) * jnp.clip(
                (vc.sf[:, None, None] - 0.7) / 0.3, 0.0, 1.0)
            du = du - kf * grid.u
            dv = dv - kf * grid.v
        grid = grid._replace(
            u=grid.u + cfg.dt * du,
            v=grid.v + cfg.dt * dv,
            T=grid.T + cfg.dt * (dT_rad + dT_vd),
            q=jnp.maximum(grid.q + cfg.dt * dq_vd, 0.0),
        )
        return state._replace(new=new, grid=grid, sfc=sfc)

    def phase_cloud(self, state: GCMState) -> GCMState:
        return self._phase_cloud_jit(state)

    def _phase_cloud_cst(self, state: GCMState) -> GCMState:
        """Cloud scheme (large-scale condensation + cloud fraction).

        evolve_model_cloud_scheme equivalent; also clears the SP tendency
        buffers (reference note 'overwrites set tendencies', splib.py:299).
        """
        cfg = self.cfg
        g = state.grid
        _, p_full = self.vc.pressures(c.pref0 * jnp.exp(g.lnps))
        T, q, ql, qi, a = physics.cloud_scheme(
            g.T, jnp.maximum(g.q, 0.0), jnp.maximum(g.ql, 0.0),
            jnp.maximum(g.qi, 0.0), jnp.clip(g.a, 0.0, 1.0),
            p_full, cfg.dt, cfg.phys)
        grid = g._replace(T=T, q=q, ql=ql, qi=qi, a=a)
        return state._replace(grid=grid, sp_tend=_zero_sp_tend())

    def phase_b(self, state: GCMState, first: bool = False) -> GCMState:
        return self._phase_b_jit(self.consts(), state, first)

    def _phase_b_cst(self, cst, state, first):
        with self.bound(cst):
            return self._phase_b_body(state, first)

    def _phase_b_body(self, state: GCMState, first: bool = False) -> GCMState:
        """Apply SP tendencies, re-analyze, time-filter, advance the clock.

        evolve_model_from_cloud_scheme equivalent.
        """
        cfg, sht = self.cfg, self.sht
        g = state.grid
        st = state.sp_tend
        dt = cfg.dt
        g = g._replace(
            u=g.u + dt * st["U"], v=g.v + dt * st["V"],
            T=g.T + dt * st["T"],
            q=jnp.maximum(g.q + dt * st["SH"], 0.0),
            ql=jnp.maximum(g.ql + dt * st["QL"], 0.0),
            qi=jnp.maximum(g.qi + dt * st["QI"], 0.0),
            a=jnp.clip(g.a + dt * st["A"], 0.0, 1.0),
        )
        vort, div = sht.vort_div_from_uv(g.u, g.v)
        new = state.new._replace(
            vort=vort, div=div,
            T=sht.analyze(g.T),
            q=sht.analyze(g.q),
            ql=sht.analyze(g.ql),
            qi=sht.analyze(g.qi),
            a=sht.analyze(g.a),
        )
        if first:
            prev = state.now  # Euler start: no filtering on step one
        else:
            prev = dycore.robert_filter(state.now, state.prev, new,
                                        cfg.robert_eps)
        # `new` is only meaningful mid-phase; aliasing it to `now` here
        # (same tracer -> same output buffer) drops the stale provisional
        # state that otherwise rides along between steps (~1.4 GB at
        # TL639/L60).
        return state._replace(
            prev=prev,
            now=new,
            new=new,
            time=state.time + dt,
        )

    def step(self, state: GCMState, first=False) -> GCMState:
        if self.cfg.split_phases:
            state = self.phase_a(state, first)
            self._tight_sync(state.grid.u)
            state = self.phase_cloud(state)
            self._tight_sync(state.grid.T)
            state = self.phase_b(state, first)
            # sync the step TAIL too: without it the next step's phase-A
            # programs dispatch while this phase_b still executes, and
            # the two steps' working sets are co-resident — enough to
            # hard-crash the worker at TL639/L60
            self._tight_sync(state.now.vort)
            return state
        return self.phase_b(self.phase_cloud(self.phase_a(state, first)),
                            first)

    # ---- column extraction (used by the coupler) ---------------------------

    def column_profiles(self, state: GCMState, col_idx):
        """Batched per-column profiles at the post-cloud-scheme point.

        col_idx: [n] flat column indices (lat-major). Returns a dict of
        [n, L] (or [n, L+1]) arrays matching the reference gcm_vars
        (spcpl.py:32), levels ordered top-first like OpenIFS.
        """
        g = state.grid
        j = col_idx // self.nlon
        i = col_idx % self.nlon
        take = lambda f: f[:, j, i].T                     # [n, L]
        ps = c.pref0 * jnp.exp(g.lnps[j, i])              # [n]
        ph_l, pf_l = self.vc.pressures(ps)                # [L+1, n], [L, n]
        pf, ph = pf_l.T, ph_l.T
        Tcols = take(g.T)
        if self.vc.hybrid:
            hc = self.vc.hybrid_coeffs(ps)
            zg_full = self.vc.geopotential_full(
                Tcols, lnr=hc["lnr"].T, alpha=hc["alpha"].T)
            zg_half = self.vc.geopotential_half(Tcols, lnr=hc["lnr"].T)
        else:
            zg_full = self.vc.geopotential_full(Tcols)    # [n, L]
            zg_half = self.vc.geopotential_half(Tcols)    # [n, L+1]
        return {
            "U": take(g.u), "V": take(g.v), "T": Tcols,
            "SH": take(g.q), "QL": take(g.ql), "QI": take(g.qi),
            "A": take(g.a), "Pfull": pf, "Phalf": ph,
            "Zgfull": zg_full, "Zghalf": zg_half,
        }

    def surface_fields(self, state: GCMState, col_idx):
        j = col_idx // self.nlon
        i = col_idx % self.nlon
        out = {}
        for k in ("Z0M", "Z0H", "QLflux", "QIflux", "SHflux", "TLflux",
                  "TSflux"):
            out[k] = state.sfc[k][j, i]
        return out

    def with_sp_tendencies(self, state: GCMState, col_idx, tend):
        """Scatter per-column tendencies into the dense SP buffers.

        tend: dict var -> [n, L]; col_idx: [n].
        """
        j = col_idx // self.nlon
        i = col_idx % self.nlon
        new_t = dict(state.sp_tend)
        shape = (self.cfg.nlev, self.nlat, self.nlon)
        for k, v in tend.items():
            base = new_t[k]
            if getattr(base, "ndim", 3) != 3:   # scalar cleared buffer
                base = jnp.broadcast_to(base, shape)
            new_t[k] = base.at[:, j, i].set(v.T)
        return state._replace(sp_tend=new_t)


class GCMModel:
    """Host-side shell with the reference-like duck-typed API."""

    support_async = False

    def __init__(self, cfg: GCMConfig = GCMConfig(), seed=0, mesh=None,
                 shard_axis=None):
        self.core = GCMCore(cfg, mesh=mesh, shard_axis=shard_axis)
        self.cfg = cfg
        self.state = self.core.initial_state(seed)
        self.mask = set()
        self.step_count = 0
        self.exp_name = "TEST"
        self.num_steps = 0
        self.step = 0
        lats = self.core.sht.latitudes_deg()
        lons = self.core.sht.longitudes_deg()
        self.latitudes = np.repeat(lats, len(lons))
        self.longitudes = np.tile(lons, len(lats))
        self.ktot = cfg.nlev
        self._start = datetime.datetime.fromisoformat(cfg.start_date)
        self._phase = "idle"
        self._first = True

    # -- lifecycle (initialize_code/commit_* are no-ops in-process) --------
    def initialize_code(self):
        pass

    def commit_parameters(self):
        pass

    def commit_grid(self):
        pass

    def cleanup_code(self):
        pass

    def stop(self):
        pass

    # -- reference API ------------------------------------------------------
    def get_start_datetime(self):
        return self._start

    def get_timestep(self):
        return float(self.cfg.dt)

    def get_model_time(self):
        return float(self.state.time)

    def get_itot(self):
        return self.core.nlon

    def get_jtot(self):
        return self.core.nlat

    def get_ktot(self):
        return self.cfg.nlev

    def set_mask(self, i):
        self.mask.add(int(i))

    def set_vdf_in_sp_mask(self, value):
        """value=True: vdiff stays ON everywhere; False: disabled in SP cols.

        NOTE the reference calls set_vdf_in_sp_mask(not couple_surface) with
        OpenIFS semantics 'True = disable vdiff inside mask'; we keep those
        semantics: value=True disables vertical diffusion in masked columns.
        """
        m = np.ones((self.core.nlat, self.core.nlon), np.float32)
        if value:
            for idx in self.mask:
                m[idx // self.core.nlon, idx % self.core.nlon] = 0.0
        self._vdf_disable_in_mask = value
        self.state = self.state._replace(vdiff_mask=jnp.asarray(m))

    def _refresh_vdiff_mask(self):
        if getattr(self, "_vdf_disable_in_mask", False):
            self.set_vdf_in_sp_mask(True)

    def evolve_model_until_cloud_scheme(self):
        self._refresh_vdiff_mask()
        self.state = self.core.phase_a(self.state, self._first)
        self._phase = "pre_cloud"
        return True

    def evolve_model_cloud_scheme(self):
        self.state = self.core.phase_cloud(self.state)
        self._phase = "post_cloud"
        return True

    def evolve_model_from_cloud_scheme(self):
        self.state = self.core.phase_b(self.state, self._first)
        self._first = False
        self._phase = "idle"
        self.step_count += 1
        return True

    def get_profile_fields(self, var, cols):
        cols = jnp.asarray(np.asarray(cols, np.int32))
        prof = self.core.column_profiles(self.state, cols)
        return np.asarray(prof[var])

    def get_profile_field(self, var, col):
        return self.get_profile_fields(var, [col])[0]

    def get_surface_field(self, var, cols):
        cols = jnp.asarray(np.asarray(cols, np.int32))
        sf = self.core.surface_fields(self.state, cols)
        return np.asarray(sf[var])

    def set_profile_tendency(self, var, col_index, profile):
        cols = jnp.asarray(np.asarray([col_index], np.int32))
        t = jnp.asarray(np.asarray(profile, np.float32))[None]
        self.state = self.core.with_sp_tendencies(self.state, cols, {var: t})

    def write_restart(self):
        pass

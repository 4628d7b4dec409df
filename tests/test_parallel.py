"""Multi-device sharding tests on the 8-virtual-CPU-device mesh.

Validates the parallel plan of SURVEY.md section 2.4 without
accelerators: instance parallelism over the `les` axis (P1) and intra-LES
horizontal domain decomposition over `x`/`y` (P2, DALES nprocx*nprocy +
halo exchange -> GSPMD collective-permutes inserted around the stencil
rolls).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sp_coupler.models.les import (grid as lgrid, state as lstate,
                                       step as lstep)
from sp_coupler.models.les.state import LESForcing
from sp_coupler.parallel import mesh as pmesh, sharding as shd

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _tiny_fleet(n):
    g = lgrid.LESGrid(nx=16, ny=16, nz=16, dx=200.0, dy=200.0, dz=100.0)
    nz = g.nz
    zf = np.asarray(g.zf())
    thl0 = jnp.asarray(298.0 + 0.006 * zf, jnp.float32)
    qt0 = jnp.asarray(14e-3 * np.exp(-zf / 2500.0), jnp.float32)
    u0 = jnp.asarray(-8.0 + 1e-3 * zf, jnp.float32)
    v0 = jnp.full(nz, -4.0, jnp.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(42), i))(jnp.arange(n))
    st = jax.vmap(lambda k: lstate.init_state(g, u0, v0, thl0, qt0,
                                              1.0e5, k))(keys)
    frc = jax.vmap(lambda _: LESForcing.zeros(nz))(jnp.arange(n))
    return g, st, frc


def _evolve(g, phys, mesh):
    def f(st, frc):
        st = shd.constrain_fleet(st, mesh)
        st, nsub, _ = jax.vmap(
            lambda s, fr: lstep.evolve_adaptive(g, phys, s, fr,
                                                s.time + 20.0, dt_max=5.0))(
            st, frc)
        return shd.constrain_fleet(st, mesh), nsub
    return jax.jit(f)


class TestSpatialSharding:
    def test_spatial_matches_single_device(self):
        """P('les', None, 'y', 'x') evolve == unsharded evolve."""
        g, st, frc = _tiny_fleet(2)
        phys = lstep.LESPhysics()

        ref_state, _ = _evolve(g, phys, None)(st, frc)

        mesh = pmesh.make_mesh(n_les=2, n_x=2, n_y=2)
        assert shd.spatial_axes(mesh)
        with jax.set_mesh(mesh):
            st_sh = pmesh.shard_fleet(st, mesh, spatial=True)
            out_state, _ = _evolve(g, phys, mesh)(st_sh, frc)
        for k in ("u", "v", "w", "thl", "qt", "e12"):
            a = np.asarray(getattr(ref_state, k))
            b = np.asarray(getattr(out_state, k))
            np.testing.assert_allclose(b, a, atol=5e-4, rtol=1e-4,
                                       err_msg=k)

    def test_les_axis_sharding(self):
        """Pure instance parallelism: 8 instances over 8 devices."""
        g, st, frc = _tiny_fleet(8)
        phys = lstep.LESPhysics()
        mesh = pmesh.make_mesh(n_les=8)
        assert not shd.spatial_axes(mesh)
        with jax.set_mesh(mesh):
            st_sh = pmesh.shard_fleet(st, mesh)
            out_state, nsub = _evolve(g, phys, mesh)(st_sh, frc)
        thl = np.asarray(out_state.thl)
        assert np.all(np.isfinite(thl))
        assert int(np.asarray(nsub)[0]) >= 4


class TestGCMSpectralSharding:
    """Reference P3 (--gcmprocs / OpenIFS NPROC): latitude-band sharding of
    the spherical-harmonic transforms; GSPMD inserts the all-reduce that
    plays the role of the reference GCM's MPI transposes."""

    def test_transform_roundtrip_sharded(self):
        from sp_coupler.models.gcm import spharm
        mesh = pmesh.make_mesh(n_les=8)
        ref = spharm.SpectralTransform(21)
        sh = spharm.SpectralTransform(21, mesh=mesh, axis="les")
        rng = np.random.default_rng(0)
        s = jnp.asarray(rng.normal(size=(3, ref.M, ref.N, 2)), jnp.float32)
        s = s * ref.mask[..., None]
        g_ref = jax.jit(ref.synthesize)(s)
        a_ref = jax.jit(ref.analyze)(g_ref)
        with jax.set_mesh(mesh):
            g_sh = jax.jit(sh.synthesize)(s)
            a_sh = jax.jit(sh.analyze)(g_sh)
        np.testing.assert_allclose(np.asarray(g_sh), np.asarray(g_ref),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(a_sh), np.asarray(a_ref),
                                   atol=1e-5, rtol=1e-5)

    def test_gcm_step_sharded_matches(self):
        from sp_coupler.models.gcm import model as gcm_model
        cfg = gcm_model.GCMConfig(trunc=10, nlev=8, dt=600.0)
        core_ref = gcm_model.GCMCore(cfg)
        s0 = core_ref.initial_state(seed=0)
        ref = core_ref.step(s0, first=True)

        mesh = pmesh.make_mesh(n_les=8)
        core_sh = gcm_model.GCMCore(cfg, mesh=mesh, shard_axis="les")
        with jax.set_mesh(mesh):
            s0s = core_sh.initial_state(seed=0)
            out = core_sh.step(s0s, first=True)
        # lat-sharded Legendre contractions sum in a different order than
        # the single-device einsum -> f32 round-off level differences
        for name in ("vort", "div", "T", "q"):
            a = np.asarray(getattr(ref.now, name))
            b = np.asarray(getattr(out.now, name))
            np.testing.assert_allclose(b, a, atol=2e-4, rtol=1e-3,
                                       err_msg=name)
        np.testing.assert_allclose(np.asarray(out.grid.T),
                                   np.asarray(ref.grid.T),
                                   atol=5e-3, rtol=1e-4)


    @pytest.mark.slow   # SL variant of the sharded-step equality; the
    # Eulerian variant (test_gcm_step_sharded_matches) stays fast
    def test_gcm_step_sharded_matches_sl(self):
        """Same lat-band sharding check for the SEMI-LAGRANGIAN path:
        the departure gathers / ghost-row rolls must survive GSPMD."""
        from sp_coupler.models.gcm import model as gcm_model
        cfg = gcm_model.GCMConfig(trunc=10, nlev=8, dt=600.0,
                                  advection="sl")
        core_ref = gcm_model.GCMCore(cfg)
        s0 = core_ref.initial_state(seed=0)
        ref = core_ref.step(core_ref.step(s0, first=True))

        mesh = pmesh.make_mesh(n_les=8)
        core_sh = gcm_model.GCMCore(cfg, mesh=mesh, shard_axis="les")
        with jax.set_mesh(mesh):
            s0s = core_sh.initial_state(seed=0)
            out = core_sh.step(core_sh.step(s0s, first=True))
        for name in ("vort", "div", "T", "q"):
            a = np.asarray(getattr(ref.now, name))
            b = np.asarray(getattr(out.now, name))
            np.testing.assert_allclose(b, a, atol=2e-4, rtol=1e-3,
                                       err_msg=name)


class TestScalingEfficiency:
    def test_fixed_work_efficiency_structural(self):
        """BASELINE metric 3 harness: with fixed total work, the sharded
        program must reach >= 0.8 of the same-size unpartitioned ideal
        (m independent per-device programs on the SAME devices — identical
        core budget, so efficiency is <= 1 by construction and genuine
        partitioner/collective overhead can actually fail the gate;
        VERDICT r3 next-round #3)."""
        from sp_coupler.runtime import scalebench
        r = scalebench.measure(sizes=[1, 4], per_dev=1, nx=16, ny=16,
                               nz=16, substeps=3, reps=4, verbose=False,
                               mode="fixed")
        eff = r["efficiency"]
        # raw (unclamped) ratios; on the CPU test mesh the independent
        # ideal programs contend for the shared host thread pool, so a
        # systematic margin above 1.0 is expected (see scalebench.measure)
        assert all(v <= 1.25 for v in eff.values()), r
        assert eff["4"] >= 0.8, r


@pytest.mark.slow
class TestProductionPlaneSharding:
    """VERDICT r2 item 8: spatial (x, y) sharding at the PRODUCTION plane
    size — one 64x64x160 instance (the BASELINE case grid) split 2x2 —
    must reproduce the unsharded trajectory over a real substep count.
    Small-grid tests miss halo-width/padding interactions at real sizes."""

    def _one_instance(self):
        g = lgrid.LESGrid()          # 64 x 64 x 160, 200 m / 25 m
        zf = np.asarray(g.zf())
        thl0 = jnp.asarray(297.9 + np.maximum(zf - 740.0, 0.0)
                           * 19.1 / 3260.0, jnp.float32)
        qt0 = jnp.asarray(16e-3 * np.exp(-zf / 2500.0), jnp.float32)
        u0 = jnp.asarray(-9.9 + 2e-3 * zf, jnp.float32)
        v0 = jnp.full(g.nz, -3.8, jnp.float32)
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.PRNGKey(42), i))(jnp.arange(1))
        st = jax.vmap(lambda k: lstate.init_state(g, u0, v0, thl0, qt0,
                                                  1.0e5, k))(keys)
        f0 = LESForcing.zeros(g.nz)._replace(
            wthl=jnp.asarray(0.012, jnp.float32),
            wqt=jnp.asarray(4e-5, jnp.float32),
            z0m=jnp.asarray(0.1, jnp.float32),
            z0h=jnp.asarray(0.02, jnp.float32))
        frc = jax.tree.map(lambda x: jnp.broadcast_to(x, (1,) + x.shape),
                           f0)
        return g, st, frc

    def test_64x64x160_split_2x2_matches_unsharded(self):
        g, st, frc = self._one_instance()
        phys = lstep.LESPhysics()
        n_sub = 20

        def make(mesh):
            def f(s, fr):
                s = shd.constrain_fleet(s, mesh)
                s = jax.vmap(lambda si, fi: lstep.evolve(
                    g, phys, si, fi, 2.0, n_sub))(s, fr)
                return shd.constrain_fleet(s, mesh)
            return jax.jit(f)

        ref = make(None)(st, frc)
        mesh = pmesh.make_mesh(n_les=1, n_x=2, n_y=2,
                               devices=jax.devices()[:4])
        with jax.set_mesh(mesh):
            st_sh = pmesh.shard_fleet(st, mesh, spatial=True)
            out = make(mesh)(st_sh, frc)
        for k in ("u", "v", "w", "thl", "qt", "e12", "qr"):
            a = np.asarray(getattr(ref, k))
            b = np.asarray(getattr(out, k))
            assert np.all(np.isfinite(b)), k
            # GSPMD reduction/halo ordering: f32 round-off accumulated
            # over 20 substeps of the 5th-order stencil path
            np.testing.assert_allclose(b, a, atol=2e-3, rtol=2e-3,
                                       err_msg=k)

    def test_fused_coupled_step_spatially_sharded(self):
        """The FUSED coupled step (T10 GCM + one 64x64x160 instance) runs
        spatially sharded and matches the unsharded coupled step."""
        from sp_coupler.models.gcm import model as gcm_model
        from sp_coupler.models.les import diag as ldiag
        from sp_coupler.coupling.coupler import CoupledStepFn

        g, st, _ = self._one_instance()
        phys = lstep.LESPhysics()
        gcfg = gcm_model.GCMConfig(trunc=10, nlev=8, dt=60.0)

        def run(mesh):
            core = gcm_model.GCMCore(gcfg)
            gs = core.initial_state(seed=0)
            cols = np.asarray([100], np.int32)
            fn = CoupledStepFn(core, g, phys, cols, dt_les=15.0,
                               n_substeps=0, mesh=mesh)
            prof0 = jax.vmap(lambda s: ldiag.slab_profiles(g, s))(st)
            prof0 = jax.tree.map(np.asarray, prof0)
            s0 = st
            if mesh is not None:
                s0 = pmesh.shard_fleet(st, mesh, spatial=True)
            out = fn(gs, s0, prof0, np.zeros(1, np.float32), 0,
                     first=True)
            return jax.block_until_ready(out)

        _, les_ref, prof_ref, _, _ = run(None)
        mesh = pmesh.make_mesh(n_les=1, n_x=2, n_y=2,
                               devices=jax.devices()[:4])
        with jax.set_mesh(mesh):
            _, les_sh, prof_sh, _, _ = run(mesh)
        np.testing.assert_allclose(np.asarray(prof_sh["THL"]),
                                   np.asarray(prof_ref["THL"]),
                                   atol=5e-3, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(les_sh.thl),
                                   np.asarray(les_ref.thl),
                                   atol=5e-3, rtol=1e-3)

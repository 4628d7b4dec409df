"""Spherical-harmonic transforms on the Gaussian grid (pure JAX).

The replacement for the spectral-transform core of the
reference's external GCM (OpenIFS, consumed through the splib call sites —
SURVEY.md section 2.2): real FFT in longitude plus Legendre transforms
expressed as einsums over precomputed associated-Legendre tables, so the
O(nlat * M * N) contraction is a batched matmul. Transposes that a
distributed-memory spectral model does with MPI all-to-alls are simply
sharded-einsum layouts here.

Conventions:
- triangular truncation T; coefficient arrays are PACKED REAL
  [..., M, N, 2] with M = T+1 zonal wavenumbers (m >= 0; m < 0 implied by
  conjugate symmetry), N = T+2 total wavenumbers (the extra n = T+1 row is
  recurrence workspace, kept zero in prognostic state), and the last axis
  holding (real, imag). No complex arithmetic reaches the compiled
  program: the zonal stage is a real DFT matmul (_build_dft).
- P tables are orthonormal on mu in [-1, 1]: sum_j w_j P[j,m,n]^2 = 1.
- grid arrays are [..., nlat, nlon], latitude index j runs north -> south.

On the REDUCED Gaussian grid (OpenIFS runs one: fewer longitudes per
ring toward the poles, ~30% fewer points): deliberately NOT implemented.
A reduced grid makes every grid-space array ragged (per-ring nlon),
which fragments the Legendre einsum batching, the pointwise physics,
and the SL interpolation gathers into per-ring shapes — while the dominant high-truncation cost
(the Legendre contraction, O(nlat * M * N) per field) does not shrink at
all with a reduced grid. The framework instead takes the saving the
dense-tensor way: the LINEAR truncation grid at TL639 (1280 x 640 vs the
quadratic 1920 x 960 — GRID_FOR_TRUNC below), which removes 2.25x of
grid-space work against the alias-free grid with zero raggedness. The
~1.3x further reduction a reduced grid would give to the grid-space
minority of the step is not worth making every hot loop shape-dynamic.
"""

import contextlib
import functools

import numpy as np
import jax
import jax.numpy as jnp

# spectral transforms need true f32 products: a reduced-precision matmul
# (bf16 or TF32 inputs, ~3 decimal digits, which a GPU may use for a
# DEFAULT f32 matmul) is visible in balanced dycore states and breaks
# parity with the CPU. HIGHEST = full f32.
_PREC = jax.lax.Precision.HIGHEST

# Gaussian grids per truncation: quadratic (alias-free) unless noted.
GRID_FOR_TRUNC = {
    10: (32, 16),
    21: (64, 32),
    31: (96, 48),
    42: (128, 64),
    63: (192, 96),
    85: (256, 128),
    106: (320, 160),
    159: (480, 240),
    213: (640, 320),
    255: (768, 384),
    319: (960, 480),   # linear-ish
    639: (1280, 640),  # linear (TL639)
}


def gaussian_latitudes(nlat):
    """(mu, w): Gaussian nodes (sin latitude) and weights, north->south."""
    mu, w = np.polynomial.legendre.leggauss(nlat)
    order = np.argsort(-mu)  # north first
    return mu[order], w[order]


@functools.lru_cache(maxsize=8)
def legendre_tables(trunc, nlat):
    """(P, H) tables as numpy float64: [nlat, M, N].

    P[j, m, n] = orthonormal associated Legendre P̄_n^m(mu_j); zero for n < m.
    H[j, m, n] = (1 - mu^2) dP̄_n^m/dmu, from the recurrence
        H_nm = -n eps_{n+1,m} P_{n+1,m} + (n+1) eps_{nm} P_{n-1,m},
        eps_nm = sqrt((n^2 - m^2) / (4 n^2 - 1)).
    """
    M = trunc + 1
    N = trunc + 2
    mu, _ = gaussian_latitudes(nlat)
    sinl = np.sqrt(1.0 - mu ** 2)
    # need P up to n = trunc + 2 for H at n = trunc + 1
    NP = trunc + 3
    P = np.zeros((nlat, M, NP))
    P[:, 0, 0] = 1.0 / np.sqrt(2.0)
    for m in range(1, M):
        P[:, m, m] = -np.sqrt((2 * m + 1) / (2.0 * m)) * sinl * P[:, m - 1, m - 1]
    for m in range(M):
        if m + 1 < NP:
            P[:, m, m + 1] = mu * np.sqrt(2 * m + 3.0) * P[:, m, m]
        for n in range(m + 2, NP):
            a = np.sqrt((4.0 * n * n - 1.0) / (n * n - m * m))
            b = np.sqrt(((n - 1.0) ** 2 - m * m) / (4.0 * (n - 1.0) ** 2 - 1.0))
            P[:, m, n] = a * (mu * P[:, m, n - 1] - b * P[:, m, n - 2])
    eps = np.zeros((M, NP + 1))
    for m in range(M):
        for n in range(m, NP + 1):
            if n > 0:
                eps[m, n] = np.sqrt(max(n * n - m * m, 0.0) /
                                    (4.0 * n * n - 1.0))
    H = np.zeros((nlat, M, N))
    for m in range(M):
        for n in range(m, N):
            t = (n + 1.0) * eps[m, n] * (P[:, m, n - 1] if n - 1 >= m else 0.0)
            t = t - n * eps[m, n + 1] * P[:, m, n + 1]
            H[:, m, n] = t
    return P[:, :, :N], H


class SpectralTransform:
    """Precomputed transform operator for one (truncation, grid) pair.

    Sharding (reference P3, --gcmprocs / OpenIFS NPROC): pass
    ``mesh``/``axis`` to lay grid space out in latitude bands over that
    mesh axis. Constraints are placed at the transform boundaries only;
    GSPMD then keeps the whole grid-space physics chain lat-sharded and
    turns the Legendre contraction into partial sums + an all-reduce —
    the role of the reference GCM's MPI transposes. Spectral coefficients
    are tiny (M x N x 2 per level) and stay replicated.
    """

    def __init__(self, trunc, nlat=None, nlon=None, radius=6.371e6,
                 dtype=jnp.float32, mesh=None, axis=None):
        if nlat is None or nlon is None:
            nlon, nlat = GRID_FOR_TRUNC[trunc]
        self._mesh = mesh
        self._axis = axis if mesh is not None else None
        self.trunc = trunc
        self.nlat = nlat
        self.nlon = nlon
        self.radius = radius
        self.M = trunc + 1
        self.N = trunc + 2
        mu, w = gaussian_latitudes(nlat)
        P, H = legendre_tables(trunc, nlat)
        rdtype = dtype
        self.mu = jnp.asarray(mu, rdtype)
        self.w = jnp.asarray(w, rdtype)
        self.cosl = jnp.asarray(np.sqrt(1 - mu ** 2), rdtype)
        # Equatorial-symmetry folding: P_n^m(-mu) = (-1)^{n+m} P_n^m(mu)
        # (and the opposite parity for H = (1-mu^2) dP/dmu). Tables are
        # stored for the NORTH half only, split into even/odd (n - m)
        # parity classes with the n index PACKED (n = m + 2k) — so each
        # Legendre contraction runs at HALF the rows and HALF the columns
        # of the naive [nlat, M, N] einsum: 2x fewer matmul FLOPs and 4x
        # less table memory than round 2 (which also kept premultiplied
        # Pw/Hw copies; at TL639 those were ~4 GB of closure constants
        # serialized into every lowered module — brutal for remote
        # compiles). The quadrature weight is folded into the small
        # zonal-spectra arrays instead (_wq).
        assert nlat % 2 == 0
        jn = nlat // 2
        self.jn = jn
        Ke = (self.N + 1) // 2
        self.Ke = Ke
        ms = np.arange(self.M)[:, None]
        ks = np.arange(Ke)[None, :]
        n_e = ms + 2 * ks                       # class n-m even
        n_o = n_e + 1
        ve = n_e < self.N
        vo = n_o < self.N
        idx_e = np.minimum(n_e, self.N - 1)
        idx_o = np.minimum(n_o, self.N - 1)
        marr = np.arange(self.M)[:, None]
        self.Pe = jnp.asarray(P[:jn, marr, idx_e] * ve, rdtype)
        self.Po = jnp.asarray(P[:jn, marr, idx_o] * vo, rdtype)
        # NO H tables at all: the derivative transform is the exact
        # banded recurrence H_nm = -n eps_{n+1,m} P_{n+1,m}
        # + (n+1) eps_{nm} P_{n-1,m}, i.e. a P-transform of SHIFTED
        # coefficients (_h_shift / _h_shift_adj below) — another 2x off
        # the table memory and the per-transform HBM traffic
        n_full = np.arange(self.N + 1)[None, :]
        m_full = np.arange(self.M)[:, None]
        eps = np.sqrt(np.maximum(n_full ** 2 - m_full ** 2, 0.0)
                      / np.maximum(4.0 * n_full ** 2 - 1.0, 1.0))
        nv = np.arange(self.N)[None, :]
        self._c_up = jnp.asarray((nv + 2.0) * eps[:, 1:self.N + 1], rdtype)
        self._c_dn = jnp.asarray(-(nv - 1.0) * eps[:, :self.N], rdtype)
        self._ca_up = jnp.asarray(-nv * eps[:, 1:self.N + 1], rdtype)
        self._ca_dn = jnp.asarray((nv + 1.0) * eps[:, :self.N], rdtype)
        self._idx_e = jnp.asarray(idx_e, jnp.int32)
        self._idx_o = jnp.asarray(idx_o, jnp.int32)
        self._ve = jnp.asarray(ve, rdtype)
        self._vo = jnp.asarray(vo, rdtype)
        # inverse map: for (m, n), k = (n - m) // 2 into the packed axis
        nn = np.arange(self.N)[None, :]
        dk = nn - np.arange(self.M)[:, None]
        self._k_of = jnp.asarray(
            np.clip(np.maximum(dk, 0) // 2, 0, Ke - 1), jnp.int32)
        self._class_even = jnp.asarray((dk % 2 == 0) & (dk >= 0),
                                       jnp.bool_)
        # weights / masks on (m, n)
        n_idx = np.arange(self.N)[None, :] * np.ones((self.M, 1))
        m_idx = np.arange(self.M)[:, None] * np.ones((1, self.N))
        tri = (n_idx >= m_idx) & (n_idx <= trunc)
        self.mask = jnp.asarray(tri, rdtype)
        self.n = jnp.asarray(n_idx, rdtype)
        self.m = jnp.asarray(m_idx, rdtype)
        self.laplacian = jnp.where(self.mask > 0,
                                   -n_idx * (n_idx + 1), 0.0
                                   ).astype(rdtype) / (radius ** 2)
        inv = np.zeros((self.M, self.N))
        nz = n_idx > 0
        inv[nz] = -(radius ** 2) / (n_idx * (n_idx + 1))[nz]
        self.inv_laplacian = jnp.asarray(inv * tri, rdtype)
        self._build_dft(rdtype)

    # ---- constant threading ------------------------------------------------
    # Closure-captured jnp arrays are serialized into every lowered module;
    # at TL639 the Legendre tables are ~0.5 GB and break the remote-compile
    # transport. Callers that jit whole steps thread these through as
    # ARGUMENTS instead: grab them with consts() and re-bind the live
    # tracers around the traced body with bound() (GCMCore does this for
    # all its jitted phases).
    _CONST_KEYS = ("Pe", "Po", "Ffwd", "Finv")

    def consts(self):
        return {k: getattr(self, k) for k in self._CONST_KEYS}

    @contextlib.contextmanager
    def bound(self, c):
        if not c:
            yield
            return
        old = {k: getattr(self, k) for k in c}
        for k, v in c.items():
            setattr(self, k, v)
        try:
            yield
        finally:
            for k, v in old.items():
                setattr(self, k, v)

    # ---- packing helpers ---------------------------------------------------

    @staticmethod
    def pack(z):
        """complex [..., M, N] -> packed real [..., M, N, 2]."""
        return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)

    @staticmethod
    def unpack(s):
        """packed real [..., M, N, 2] -> complex [..., M, N]."""
        return s[..., 0] + 1j * s[..., 1]

    def _build_dft(self, dtype):
        """Real DFT matrices for the longitude transform.

        The zonal Fourier stage is a matmul against precomputed cos/sin
        tables instead of an FFT: M <= T+1 modes are kept anyway, and
        no complex arithmetic ever reaches the compiled program. Cost is
        O(nlon * M) per point row — negligible against the Legendre stage.
        """
        lam = 2.0 * np.pi * np.arange(self.nlon) / self.nlon
        m = np.arange(self.M)
        ang = np.outer(lam, m)                       # [nlon, M]
        fwd = np.stack([np.cos(ang), -np.sin(ang)], axis=-1) / self.nlon
        wm = np.where(m == 0, 1.0, 2.0)
        if self.nlon % 2 == 0 and self.M - 1 == self.nlon // 2:
            wm[-1] = 1.0                              # Nyquist mode
        inv = np.stack([np.cos(ang).T * wm[:, None],
                        -np.sin(ang).T * wm[:, None]], axis=1)  # [M, 2, nlon]
        self.Ffwd = jnp.asarray(fwd, dtype)          # [nlon, M, 2]
        self.Finv = jnp.asarray(inv, dtype)          # [M, 2, nlon]

    # ---- sharding ----------------------------------------------------------

    def constrain_grid(self, f, lat_from_end=2):
        """Constrain a grid-space array to latitude bands on the mesh axis.

        ``lat_from_end``: position of the latitude dim counted from the
        end (2 for [..., nlat, nlon], 3 for zonal spectra [..., nlat, M, 2]).
        No-op when the transform was built without a mesh.
        """
        if self._axis is None:
            return f
        from jax.sharding import NamedSharding, PartitionSpec as P
        spec = [None] * f.ndim
        spec[f.ndim - lat_from_end] = self._axis
        return jax.lax.with_sharding_constraint(
            f, NamedSharding(self._mesh, P(*spec)))

    def constrain_spec(self, s):
        """Constrain spectral coefficients to be replicated."""
        if self._axis is None:
            return s
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.lax.with_sharding_constraint(
            s, NamedSharding(self._mesh, P()))

    # ---- scalar transforms -------------------------------------------------

    def _fft(self, f):
        """[..., nlat, nlon] -> packed zonal spectra [..., nlat, M, 2]."""
        f = self.constrain_grid(f)
        return jnp.einsum("...i,imc->...mc", f, self.Ffwd, precision=_PREC)

    def _ifft(self, fm):
        """packed zonal spectra [..., nlat, M, 2] -> grid [..., nlat, nlon]."""
        fm = self.constrain_grid(fm, lat_from_end=3)
        return self.constrain_grid(
            jnp.einsum("...mc,mci->...i", fm, self.Finv, precision=_PREC))

    def _wq(self, fm):
        """Fold the Gaussian quadrature weight into zonal spectra."""
        return fm * self.w[:, None, None]

    # ---- symmetry-folded Legendre stages -----------------------------------

    def _pack_coeffs(self, s):
        """[..., M, N, 2] -> (even, odd) packed [..., M, Ke, 2]."""
        exp = lambda idx: jnp.broadcast_to(
            idx.reshape((1,) * (s.ndim - 3) + idx.shape + (1,)),
            s.shape[:-2] + (self.Ke, 1)).astype(jnp.int32)
        se = jnp.take_along_axis(s, exp(self._idx_e), axis=-2)
        so = jnp.take_along_axis(s, exp(self._idx_o), axis=-2)
        return (se * self._ve[..., None], so * self._vo[..., None])

    def _unpack_coeffs(self, se, so):
        """(even, odd) packed [..., M, Ke, 2] -> [..., M, N, 2]."""
        k = self._k_of
        exp = jnp.broadcast_to(
            k.reshape((1,) * (se.ndim - 3) + k.shape + (1,)),
            se.shape[:-2] + (self.N, 1)).astype(jnp.int32)
        from_e = jnp.take_along_axis(se, exp, axis=-2)
        from_o = jnp.take_along_axis(so, exp, axis=-2)
        return jnp.where(self._class_even[..., None], from_e, from_o)

    def _fold(self, fm, sign):
        """[..., nlat, M, 2] -> [..., jn, M, 2]: north +- mirrored south."""
        north = fm[..., :self.jn, :, :]
        south = jnp.flip(fm[..., self.jn:, :, :], axis=-3)
        return north + sign * south

    def _unfold(self, north, south_n):
        """North rows + south rows (in north order) -> [..., nlat, M, 2]."""
        return jnp.concatenate([north, jnp.flip(south_n, axis=-3)],
                               axis=-3)

    def _h_shift(self, s):
        """Coefficient image of the H synthesis: sum_n s_n H_nm ==
        sum_n' (_h_shift s)_n' P_n'm. Support may land on the n = T+1
        workspace row — do NOT re-mask before synthesizing."""
        up = jnp.concatenate([s[..., 1:, :], jnp.zeros_like(s[..., :1, :])],
                             axis=-2)
        dn = jnp.concatenate([jnp.zeros_like(s[..., :1, :]), s[..., :-1, :]],
                             axis=-2)
        return (self._c_up[..., None] * up + self._c_dn[..., None] * dn)

    def _h_shift_adj(self, a):
        """Adjoint: sum_j H[j,m,n] X[j] from a_n = sum_j P[j,m,n] X[j]."""
        up = jnp.concatenate([a[..., 1:, :], jnp.zeros_like(a[..., :1, :])],
                             axis=-2)
        dn = jnp.concatenate([jnp.zeros_like(a[..., :1, :]), a[..., :-1, :]],
                             axis=-2)
        return (self._ca_up[..., None] * up + self._ca_dn[..., None] * dn)

    def _syn(self, s):
        """Packed-spectral -> zonal spectra through folded tables."""
        se, so = self._pack_coeffs(s)
        fe = jnp.einsum("...mkc,jmk->...jmc", se, self.Pe, precision=_PREC)
        fo = jnp.einsum("...mkc,jmk->...jmc", so, self.Po, precision=_PREC)
        return self._unfold(fe + fo, fe - fo)

    def _ana(self, fmw):
        """Weighted zonal spectra -> packed spectral via folded tables.

        Returns the UNMASKED coefficients (the n = T+1 workspace row is
        meaningful to the H adjoint); callers mask."""
        ge = self._fold(fmw, 1.0)        # feeds the even (n-m) class
        go = self._fold(fmw, -1.0)       # feeds the odd class
        se = jnp.einsum("...jmc,jmk->...mkc", ge, self.Pe, precision=_PREC)
        so = jnp.einsum("...jmc,jmk->...mkc", go, self.Po, precision=_PREC)
        return self._unpack_coeffs(se, so)

    def analyze(self, f):
        """Grid [..., nlat, nlon] -> packed spectral [..., M, N, 2]."""
        fmw = self._wq(self._fft(f))
        return self.constrain_spec(self._ana(fmw) * self.mask[..., None])

    def synthesize(self, s):
        """Packed spectral [..., M, N, 2] -> grid [..., nlat, nlon]."""
        return self._ifft(self._syn(s * self.mask[..., None]))

    # ---- derivatives -------------------------------------------------------

    def ddlon(self, s):
        """Spectral d/dlambda: multiply by i m, on packed storage."""
        re, im = s[..., 0], s[..., 1]
        return jnp.stack([-self.m * im, self.m * re], axis=-1)

    @staticmethod
    def _mul_i(fm, mvec):
        """Multiply packed zonal spectra [..., j, m, 2] by i*m."""
        re, im = fm[..., 0], fm[..., 1]
        return jnp.stack([-mvec * im, mvec * re], axis=-1)

    def synthesize_ddmu(self, s):
        """Grid values of (1 - mu^2) df/dmu from packed spectral f."""
        return self._ifft(self._syn(self._h_shift(s * self.mask[..., None])))

    def uv_from_vort_div(self, vort, div):
        """Grid (u, v) from packed spectral vorticity & divergence.

        psi = inv_lap(vort), chi = inv_lap(div);
        u cosphi = (1/a)[dchi/dlambda - (1-mu^2) dpsi/dmu], etc.
        Returns true u, v (not cos-weighted).
        """
        psi = vort * self.inv_laplacian[..., None]
        chi = div * self.inv_laplacian[..., None]
        dchi_dl = self.synthesize(self.ddlon(chi))
        dpsi_dl = self.synthesize(self.ddlon(psi))
        dpsi_dm = self.synthesize_ddmu(psi)
        dchi_dm = self.synthesize_ddmu(chi)
        coslat = self.cosl[:, None]
        ucos = (dchi_dl - dpsi_dm) / self.radius
        vcos = (dpsi_dl + dchi_dm) / self.radius
        return ucos / coslat, vcos / coslat

    def vort_div_from_uv(self, u, v):
        """Packed spectral (vorticity, divergence) from grid (u, v).

        Integration-by-parts vector analysis:
        div_nm  = (1/a) [ analyze(i m * u/cos) - analyzeH(v/cos) ]
        vort_nm = (1/a) [ analyze(i m * v/cos) + analyzeH(u/cos) ]
        with the 1/(1-mu^2) factor folded into the cos division.
        """
        coslat = self.cosl[:, None]
        A = self._wq(self._fft(u / coslat))
        B = self._wq(self._fft(v / coslat))
        mvec = jnp.arange(self.M, dtype=u.dtype)
        iA = self._mul_i(A, mvec)
        iB = self._mul_i(B, mvec)
        div = (self._ana(iA)
               - self._h_shift_adj(self._ana(B))) / self.radius
        vort = (self._ana(iB)
                + self._h_shift_adj(self._ana(A))) / self.radius
        return (self.constrain_spec(vort * self.mask[..., None]),
                self.constrain_spec(div * self.mask[..., None]))

    def grad(self, s):
        """Grid (df/dx, df/dy) (true horizontal gradient) from spectral f."""
        dfdl = self.synthesize(self.ddlon(s))
        dfdm = self.synthesize_ddmu(s)
        coslat = self.cosl[:, None]
        return dfdl / (self.radius * coslat), dfdm / (self.radius * coslat)

    def latitudes_deg(self):
        return np.degrees(np.arcsin(np.asarray(self.mu)))

    def longitudes_deg(self):
        return np.arange(self.nlon) * 360.0 / self.nlon

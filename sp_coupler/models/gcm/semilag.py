"""Semi-Lagrangian advection for the spectral dycore (3-time-level SL-SI).

OpenIFS is a semi-Lagrangian spectral model: it runs TSTEP=900 s at T21
(/root/reference/oifs-input/fort.4:52) and ~720 s at TL639, far beyond the
Eulerian advective CFL. This module supplies that capability for the
spectral dycore: the classic three-time-level SL semi-implicit scheme of
the ECMWF lineage (Ritchie 1991; Ritchie et al. 1995), which slots into the
existing leapfrog semi-implicit solver (dycore.semi_implicit_step's matrices)
without changing its linear algebra:

    X+(x_a) = [X- + h L X-](x_d)  +  tau N(t)(x_m)  +  h L X+(x_a)

with tau the time window (2 dt; dt on the Euler start), h = tau/2, L the
semi-implicit linear operators (L_D = +lam (G T + R Tref pi), L_T = +W D,
L_pi = -b.D — vertical.py:102-131), x_d/x_m the departure/midpoint of the
great-circle trajectory, and N everything explicit minus L.

Array mapping:
- Trajectories and momentum advection use 3-D CARTESIAN unit vectors:
  no pole problem, no metric terms, and the wind components are true
  scalars under interpolation (continuous across the poles), so ONE
  interpolation kernel serves winds and tracers alike.
- Departure interpolation is cubic Lagrange (lon: uniform tensor weights;
  lat: non-uniform Gaussian nodes) over an extended grid with NGHOST
  pole-mirrored rows; the 16 taps are XLA gathers batched over ALL fields
  at once (shared indices/weights), so the gather cost is amortized over
  the whole prognostic set.
- Everything is shape-static and jit-compiles into the same one-program
  step as the Eulerian path; grid-space work stays lat-band sharded under
  the P3 mesh (spharm.constrain_grid at the transform boundaries).
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp

from ... import constants as c
from . import dycore


class SLGrid:
    """Precomputed geometry for trajectories + departure interpolation.

    ``method``: "gather" (the default, also for None) evaluates the k*k
    interpolation taps with XLA gathers. "window" exploits the physical
    bound on trajectory displacement (a few cells even at super-CFL):
    the same taps become a data-dependent STENCIL — a sum of
    statically-shifted field slices weighted by elementwise masks — with
    no gather at all. Displacements beyond the window are clamped to its
    edge (IFS-style trajectory truncation; never active below ~9-cell
    super-CFL). Which of the two is faster on the H100 at T255/TL639 is
    not measured yet.
    """

    def __init__(self, sht, nghost=12, method=None, dt=None, wind_max=150.0):
        self.sht = sht
        self.nlat, self.nlon = sht.nlat, sht.nlon
        if method is None:
            method = "gather"
        if method not in ("window", "gather"):
            raise ValueError("SLGrid method must be 'window' or 'gather', "
                             "got %r" % (method,))
        self.method = method
        # ---- window half-widths (cells) ----------------------------------
        # The lon-index displacement of a trajectory scales as 1/cos(lat):
        # a fixed index window that fits a wind_max jet at the equator is
        # silently exceeded poleward. With ``dt`` given, the windows are
        # sized from the physical design displacement wind_max * 2 dt:
        # latitude rows are grouped into <= 3 bands with a doubling ladder
        # of widths Si_b >= ceil(cells / cos(lat)) + margin, so the full
        # window covers wind_max everywhere equatorward of ~80 deg (the
        # residual polar rows keep the top width; there the *physical*
        # truncation error of an edge clamp is < (cells_exceeded) * dx_eq
        # * cos(lat) — below the resolvable scale for realistic polar
        # flow). Without ``dt`` (legacy): one band of width min(10,
        # nlon/2-4), the round-3 behavior. clamp_stats() reports how often
        # either window actually truncates.
        mu_np = np.asarray(sht.mu, np.float64)
        cosphi = np.cos(np.arcsin(mu_np))                # north -> south
        dx_eq = 2.0 * np.pi * float(sht.radius) / self.nlon
        cap = max(self.nlon // 2 - 4, 2)
        if dt is not None:
            cells = wind_max * 2.0 * float(dt) / dx_eq   # equator cells
            # lat rows are uniformly ~pi a / nlat apart; same margin
            cells_lat = wind_max * 2.0 * float(dt) / (
                np.pi * float(sht.radius) / self.nlat)
            lat_req = int(np.ceil(cells_lat)) + 1
        else:
            cells = None
            lat_req = 8
        self.ng = ng = int(min(max(nghost, lat_req + 4), self.nlat))
        self.S_lat = max(min(ng - 3, lat_req), 1)
        self.S_lon = min(10, cap)
        if cells is None:
            self.lon_bands = [([(0, self.nlat)], self.S_lon)]
        else:
            S0 = int(min(max(int(np.ceil(cells)) + 2, 3), cap))
            ladder = [S0]
            while ladder[-1] < cap and len(ladder) < 3:
                ladder.append(min(2 * ladder[-1], cap))
            req = np.ceil(cells / np.maximum(cosphi, 1e-9)) + 2
            # smallest ladder level covering each row (top level if none)
            lev = np.full(self.nlat, len(ladder) - 1, np.int64)
            for li in range(len(ladder) - 2, -1, -1):
                lev[req <= ladder[li]] = np.minimum(lev[req <= ladder[li]],
                                                    li)
            # cos is symmetric and monotone: levels form a central band
            # per level flanked by mirrored polar segments — group the
            # contiguous runs, merging the north/south pair of each level
            bands = []
            for li in range(len(ladder)):
                rows = np.flatnonzero(lev == li)
                if rows.size == 0:
                    continue
                segs = []
                r0 = rows[0]
                prev = rows[0]
                for r in rows[1:]:
                    if r != prev + 1:
                        segs.append((int(r0), int(prev) + 1))
                        r0 = r
                    prev = r
                segs.append((int(r0), int(prev) + 1))
                bands.append((segs, int(ladder[li])))
            self.lon_bands = bands
        mu = np.asarray(sht.mu, np.float64)             # north -> south
        phi = np.arcsin(mu)
        lam = 2.0 * np.pi * np.arange(self.nlon) / self.nlon
        # extended latitude nodes (descending): pole-mirrored ghost rows
        phi_ext = np.concatenate([
            (np.pi - phi[:ng])[::-1], phi, (-np.pi - phi[-ng:])[::-1]])
        self.phi = jnp.asarray(phi, jnp.float32)
        self.phi_ext = jnp.asarray(phi_ext, jnp.float32)
        self.dlon = 2.0 * np.pi / self.nlon
        # local basis at grid points [3, nlat, nlon]
        ph = phi[:, None] + 0.0 * lam[None, :]
        lm = lam[None, :] + 0.0 * phi[:, None]
        cph, sph = np.cos(ph), np.sin(ph)
        clm, slm = np.cos(lm), np.sin(lm)
        r = np.stack([cph * clm, cph * slm, sph])
        e = np.stack([-slm, clm, np.zeros_like(clm)])
        n = np.stack([-sph * clm, -sph * slm, cph])
        self.r = jnp.asarray(r, jnp.float32)
        self.e = jnp.asarray(e, jnp.float32)
        self.n = jnp.asarray(n, jnp.float32)
        self.cosphi = jnp.asarray(cph, jnp.float32)      # [nlat, nlon]

    # ---- constant threading (see spharm.SpectralTransform.consts) -----
    _CONST_KEYS = ("e", "n", "r")

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

    # ---- extension + interpolation ------------------------------------

    def extend(self, f):
        """[..., nlat, nlon] -> [..., nlat+2 ng, nlon] with pole-mirrored
        ghost rows (value at lon + 180 deg; exact for scalars, and the
        Cartesian wind components ARE scalars on the sphere)."""
        ng, half = self.ng, self.nlon // 2
        north = jnp.roll(f[..., :ng, :], half, axis=-1)[..., ::-1, :]
        south = jnp.roll(f[..., -ng:, :], half, axis=-1)[..., ::-1, :]
        return jnp.concatenate([north, f, south], axis=-2)

    def _lat_taps(self, phi_t, k):
        """Indices j0 (topmost tap row, in extended coords) and the k
        surrounding node latitudes for target phi_t."""
        neg = -self.phi_ext                              # ascending
        j = jnp.searchsorted(neg, -phi_t, side="right") - 1
        # j: phi_ext[j] >= phi_t > phi_ext[j+1]
        j0 = j - (k - 2) // 2                            # cubic: j-1; linear: j
        j0 = jnp.clip(j0, 0, self.phi_ext.shape[0] - k)
        return j0

    @staticmethod
    def _lagrange(x, nodes):
        """Lagrange weights of `x` on `nodes` (list of k arrays shaped
        like x) -> list of k weight arrays.

        Taps and weights are kept as PER-TAP LISTS, never stacked on a
        trailing size-k axis: a [K, P, k] array with k in {2, 4}
        minormost is padded to the device's minor tile on a tiled-layout
        accelerator (64x/32x padding there, which at TL639 turned a
        119 MB gather into a 7.4 GB allocation)."""
        k = len(nodes)
        w = []
        for l in range(k):
            num, den = 1.0, 1.0
            for m in range(k):
                if m == l:
                    continue
                num = num * (x - nodes[m])
                den = den * (nodes[l] - nodes[m])
            w.append(num / den)
        return w

    def interp(self, fields, lam_t, phi_t, cubic=True, out_blocks=False):
        """Interpolate a stack of fields at target points.

        fields: [F, K, nlat, nlon] (K broadcast dim, e.g. levels; the
        lat/lon taps are computed once and shared over F).
        lam_t, phi_t: [K, nlat, nlon] target angles (lam in [0, 2 pi)).
        Returns [F, K, nlat, nlon]. Dispatches on self.method (see the
        class docstring).

        out_blocks=True (split mode, requires k_chunk dividing K):
        returns the level-chunked layout [K/kc, F, kc, nlat, nlon]
        directly — skipping the multi-GB de-blocking transpose at
        TL639/L60; the consumer (sl_arrivals) iterates blocks natively.
        """
        if self.method == "window":
            out = self._interp_window(fields, lam_t, phi_t, cubic,
                                      keep_blocks=out_blocks)
            if out_blocks and out.ndim == 4:
                out = self._to_blocks(out)
            return out
        out = self._interp_gather(fields, lam_t, phi_t, cubic)
        return self._to_blocks(out) if out_blocks else out

    def _to_blocks(self, out):
        """[F, K, nlat, nlon] -> [K/kc, F, kc, nlat, nlon] (kc = k_chunk;
        identity-shaped fallback [1, F, K, ...] when chunking is off)."""
        F, K = out.shape[:2]
        kc = getattr(self, "k_chunk", None) or K
        if K % kc != 0:
            kc = K
        return jnp.swapaxes(
            out.reshape(F, K // kc, kc, self.nlat, self.nlon), 0, 1)

    def _interp_window(self, fields, lam_t, phi_t, cubic=True,
                       keep_blocks=False):
        """Windowed-stencil interpolation; dispatches to the body either
        whole or in level chunks (``k_chunk``, set by GCMCore in the
        split-phase low-memory mode): the body's per-level mask/weight
        working set is ~13 x 4 B per gridpoint-level — ~2.5 GB at
        TL639/L60 — and chunking the K axis under lax.scan caps it at
        one block's worth. Numerically identical (levels are
        independent)."""
        kc = getattr(self, "k_chunk", None)
        K = lam_t.shape[0]
        if kc and K > kc and K % kc == 0:
            nb = K // kc

            def body(_, i):
                f = jax.lax.dynamic_slice_in_dim(fields, i * kc, kc,
                                                 axis=1)
                lt = jax.lax.dynamic_slice_in_dim(lam_t, i * kc, kc,
                                                  axis=0)
                pt = jax.lax.dynamic_slice_in_dim(phi_t, i * kc, kc,
                                                  axis=0)
                return None, self._interp_window_body(f, lt, pt, cubic)

            _, out = jax.lax.scan(body, None,
                                  jnp.arange(nb, dtype=jnp.int32))
            if keep_blocks:
                return out                 # [nb, F, kc, nlat, nlon]
            # [nb, F, kc, nlat, nlon] -> [F, K, nlat, nlon]
            return jnp.swapaxes(out, 0, 1).reshape(
                fields.shape[0], K, self.nlat, self.nlon)
        return self._interp_window_body(fields, lam_t, phi_t, cubic)

    def _interp_window_body(self, fields, lam_t, phi_t, cubic=True):
        """Windowed-stencil evaluation of the same k*k Lagrange taps.

        value(r, c) = sum_dj sum_di wlat_dj wlon_di f[j0+dj, i1+di]
                    = sum_sj sum_si A_sj(r, c) B_si(r, c) f[r+sj, c+si]

        with A_sj = sum_dj wlat_dj [j0 - j_row + dj = sj] and
        B_si = sum_di wlon_di [d_lon + di0 + di = si]: because the tap
        offsets are bounded by the trajectory CFL, the gather becomes a
        static double loop of shifted slices weighted by elementwise
        masks — elementwise work with no general gather. Tap weights
        are identical to the gather path; displacements beyond the
        window are clamped to its edge (trajectory truncation — never
        active below ~(S_lat)-cell super-CFL).
        """
        k = 4 if cubic else 2
        F = fields.shape[0]
        K, nlat, nlon = lam_t.shape
        ng = self.ng
        Sj = min(self.S_lat, ng - k + 1)
        di0 = -1 if cubic else 0
        bands = [(segs, min(Si, nlon // 2 - k))
                 for segs, Si in self.lon_bands]
        pad = max(Si for _, Si in bands) + k

        xi = lam_t / self.dlon
        i1 = jnp.floor(xi).astype(jnp.int32)
        t = xi - i1
        i_col = jnp.arange(nlon, dtype=jnp.int32)[None, None, :]
        dlon = i1 - i_col
        dlon = (dlon + nlon // 2) % nlon - (nlon // 2)  # wrap to signed
        phi_ext = self.phi_ext

        # ---- lat taps WITHOUT searchsorted / table gathers (this is
        # the gather-free method; both would lower to general gathers,
        # and this routine needs dozens). The target row is
        # within the window of the arrival row, so the bracketing offset
        # is a count of vectorized compares against statically sliced
        # node latitudes, and the k node latitudes come from the same
        # selects.
        def prow(s, l=0):
            # phi_ext[ng + r + s + l] as a broadcastable [1, nlat, 1]
            return phi_ext[ng + s + l: ng + s + l + nlat][None, :, None]

        cnt = jnp.zeros_like(dlon)
        for s in range(-Sj, Sj + 1):
            cnt = cnt + (prow(s) >= phi_t).astype(jnp.int32)
        djn = cnt - (Sj + 1)          # phi_ext[j_row+djn] >= phi > next
        djb = jnp.clip(djn - (k - 2) // 2, -Sj, Sj)   # topmost lat tap
        nodes = []
        for l in range(k):
            nl = jnp.zeros_like(phi_t)
            for s in range(-Sj, Sj + 1):
                nl = nl + jnp.where(djb == s, prow(s, l), 0.0)
            nodes.append(nl)
        # Weight evaluation point clamped to the stencil span (nodes are
        # descending; a no-op whenever the bracket did not saturate): a
        # super-window lat displacement degrades to edge-value truncation
        # instead of cubic EXTRApolation with polynomially growing weights.
        phi_w = jnp.clip(phi_t, nodes[-1], nodes[0])
        wlat = self._lagrange(phi_w, nodes)           # k x [K, nlat, nlon]
        if cubic:
            wlon = [
                -t * (t - 1.0) * (t - 2.0) / 6.0,
                (t * t - 1.0) * (t - 2.0) / 2.0,
                -t * (t + 1.0) * (t - 2.0) / 2.0,
                t * (t * t - 1.0) / 6.0]
        else:
            wlon = [1.0 - t, t]

        def seg_cat(x, segs):
            """Concatenate a band's latitude segments ([K, ., nlon])."""
            if len(segs) == 1:
                r0, r1 = segs[0]
                return x[..., r0:r1, :]
            return jnp.concatenate([x[..., r0:r1, :] for r0, r1 in segs],
                                   axis=-2)

        # per-band target-side arrays (shared across fields and lat
        # shifts; north/south polar segments of one band are processed
        # together so the stencil passes are emitted once per band)
        btgt = []
        for segs, Si in bands:
            btgt.append((jnp.clip(seg_cat(dlon, segs), -Si, Si),
                         [seg_cat(w, segs) for w in wlat],
                         [seg_cat(w, segs) for w in wlon],
                         seg_cat(djb, segs)))

        outs = []
        for fi in range(F):
            ext = self.extend(fields[fi])             # [K, J_ext, nlon]
            padded = jnp.concatenate(
                [ext[..., -pad:], ext, ext[..., :pad]], axis=-1)
            pieces = []                               # (r0, rows) chunks
            for (segs, Si), (dl_b, wlat_b, wlon_b, djb_b) in zip(bands,
                                                                 btgt):
                rows_b = sum(r1 - r0 for r0, r1 in segs)
                acc = jnp.zeros((K, rows_b, nlon), fields.dtype)
                for sj in range(-Sj, Sj + k):
                    A = jnp.zeros_like(dl_b, dtype=wlat_b[0].dtype)
                    for dj in range(k):
                        A = A + jnp.where(djb_b + dj == sj, wlat_b[dj],
                                          0.0)
                    row = seg_cat(
                        padded[:, ng + sj: ng + sj + nlat, :], segs)
                    P = jnp.zeros((K, rows_b, nlon), fields.dtype)
                    for si in range(-Si + di0, Si + di0 + k):
                        B = jnp.zeros_like(A)
                        for di in range(k):
                            B = B + jnp.where(dl_b + di0 + di == si,
                                              wlon_b[di], 0.0)
                        P = P + B * row[..., pad + si: pad + si + nlon]
                    acc = acc + A * P
                    # one barrier per lat-shift: the inner passes fuse
                    # into one elementwise kernel; segments run sequentially so
                    # the scheduler holds one segment's buffers at a
                    # time (an unconstrained schedule materialized every
                    # pass: a 127 GB HLO-temp plan)
                    (acc, padded) = jax.lax.optimization_barrier(
                        (acc, padded))
                off = 0
                for r0, r1 in segs:
                    pieces.append((r0, acc[:, off:off + (r1 - r0), :]))
                    off += r1 - r0
            pieces.sort(key=lambda p: p[0])
            outs.append(pieces[0][1] if len(pieces) == 1 else
                        jnp.concatenate([p[1] for p in pieces], axis=1))
        return jnp.stack(outs)

    def clamp_stats(self, lam_t, phi_t, cubic=True):
        """Fraction of target points whose displacement exceeds the
        window and is edge-truncated (jit-safe observability for the
        trajectory truncation; advisor round-4 item)."""
        k = 4 if cubic else 2
        K, nlat, nlon = lam_t.shape
        Sj = min(self.S_lat, self.ng - k + 1)
        xi = lam_t / self.dlon
        i1 = jnp.floor(xi).astype(jnp.int32)
        i_col = jnp.arange(nlon, dtype=jnp.int32)[None, None, :]
        dlon = i1 - i_col
        dlon = (dlon + nlon // 2) % nlon - (nlon // 2)
        lon_exc = jnp.zeros((), jnp.float32)
        for segs, Si in self.lon_bands:
            Si = min(Si, nlon // 2 - k)
            for r0, r1 in segs:
                lon_exc = lon_exc + jnp.sum(
                    (jnp.abs(dlon[:, r0:r1]) > Si).astype(jnp.float32))
        phi_ext = self.phi_ext
        ng = self.ng

        def prow(s):
            return phi_ext[ng + s: ng + s + nlat][None, :, None]

        cnt = jnp.zeros(lam_t.shape, jnp.int32)
        for s in range(-Sj, Sj + 1):
            cnt = cnt + (prow(s) >= phi_t).astype(jnp.int32)
        djn = cnt - (Sj + 1)
        raw = djn - (k - 2) // 2
        lat_exc = jnp.sum(((raw < -Sj) | (raw > Sj)).astype(jnp.float32))
        npts = float(K * nlat * nlon)
        return {"lon": lon_exc / npts, "lat": lat_exc / npts}

    def _interp_gather(self, fields, lam_t, phi_t, cubic=True):
        """Gather-tap evaluation (CPU path).

        Memory layout (TL639 is HBM-bound, not FLOP-bound here): the
        field axis runs under lax.scan so only ONE field's extended
        grid, gather index, and tap values are live at a time — an
        all-fields gather holds several [F, K, nlat, nlon] temporaries
        (~1.5 GB each at TL639/L60) at once and OOMs the 16 GB chip.
        Within a field the k*k taps are unrolled with the index computed
        at the use site, and the per-tap Lagrange weights are
        recomputed in-body from the scalar offsets (elementwise chains
        that XLA fuses into the gather epilogue) instead of being kept
        as [k, K, P] stacks (~1.6 GB live for the cubic pair). Per-tap
        lists, never a trailing size-k axis: k in {2, 4} minormost gets
        padded to the minor tile of a tiled-layout accelerator. Tap summation
        order (dj-major) is unchanged -> bitwise-identical results.
        Indices are in bounds by construction (j0 clipped, col wrapped)
        -> promise_in_bounds skips the clamp/select of the default mode.
        """
        k = 4 if cubic else 2
        F = fields.shape[0]
        K = lam_t.shape[0]
        lam_f = lam_t.reshape(K, -1)
        phi_f = phi_t.reshape(K, -1)

        # ---- longitude taps (uniform nodes)
        xi = lam_f / self.dlon
        i1 = jnp.floor(xi).astype(jnp.int32)
        t = xi - i1                                       # in [0, 1)
        di0 = -1 if cubic else 0

        # ---- latitude taps (non-uniform Gaussian nodes)
        j0 = self._lat_taps(phi_f, k)                     # [K, P]
        phi_ext = self.phi_ext
        nlon = self.nlon

        def wlon_tap(di, tt):
            if not cubic:
                return 1.0 - tt if di == 0 else tt
            return [
                lambda: -tt * (tt - 1.0) * (tt - 2.0) / 6.0,
                lambda: (tt * tt - 1.0) * (tt - 2.0) / 2.0,
                lambda: -tt * (tt + 1.0) * (tt - 2.0) / 2.0,
                lambda: tt * (tt * tt - 1.0) / 6.0][di]()

        def field_tap_sum(seq, f):
            bj0, bi1, bt, bphi = seq
            ext = self.extend(f).reshape(K, -1)           # [K, Jext*nlon]
            acc = jnp.zeros_like(phi_f, dtype=fields.dtype)
            for dj in range(k):
                for di in range(k):
                    # per-tap Lagrange weight, recomputed in-body from
                    # the tiny phi_ext table (fuses into the gather
                    # epilogue; same op order as _lagrange -> bitwise
                    # identical to a precomputed [k, K, P] weight stack)
                    nodes = [phi_ext[bj0 + l] for l in range(k)]
                    # weight point clamped to the stencil span (no-op
                    # unless j0 saturated at the extended-grid edge):
                    # edge truncation instead of cubic extrapolation
                    bphi_c = jnp.clip(bphi, nodes[k - 1], nodes[0])
                    num, den = 1.0, 1.0
                    for m in range(k):
                        if m == dj:
                            continue
                        num = num * (bphi_c - nodes[m])
                        den = den * (nodes[dj] - nodes[m])
                    wl = num / den
                    row = (bj0 + dj) * nlon               # [K, P]
                    col = jnp.remainder(bi1 + di0 + di, nlon)
                    vals = jnp.take_along_axis(
                        ext, row + col, axis=-1, mode="promise_in_bounds")
                    acc = acc + vals * (wl * wlon_tap(di, bt))
                    # chain the taps: without this barrier XLA schedules
                    # all k*k gathers concurrently (they only meet at
                    # acc), holding every tap's index/value temporaries
                    # at once — ~6 GB at TL639/L60. Identity on values.
                    (acc, ext, bj0, bi1, bt,
                     bphi) = jax.lax.optimization_barrier(
                        (acc, ext, bj0, bi1, bt, bphi))
            return (bj0, bi1, bt, bphi), acc

        # Unrolled Python loop over fields (NOT lax.scan: scan buffers a
        # private copy of xs — another ~1.5 GB at TL639/L60); the barrier
        # chain threads each field's index arrays through the previous
        # field's accumulator so the per-field working sets run
        # sequentially, one at a time.
        seq = (j0, i1, t, phi_f)
        outs = []
        for fi in range(F):
            seq, acc = field_tap_sum(seq, fields[fi])
            outs.append(acc)
        out = jnp.stack(outs)
        return out.reshape((F, K, self.nlat, self.nlon))

    # ---- trajectories ---------------------------------------------------

    @staticmethod
    def _angles(rv):
        """Unit vectors [3, ...] -> (lam in [0, 2 pi), phi)."""
        phi = jnp.arcsin(jnp.clip(rv[2], -1.0, 1.0))
        lam = jnp.arctan2(rv[1], rv[0])
        lam = jnp.where(lam < 0.0, lam + 2.0 * np.pi, lam)
        return lam, phi

    def trajectories(self, u, v, half_tau, radius, iters=2):
        """Great-circle departure/midpoint angles from winds at time t.

        u, v: [K, nlat, nlon]. Returns (lam_d, phi_d), (lam_m, phi_m),
        each [K, nlat, nlon]. Midpoint iteration (McDonald 1986 fixed
        point): r_m <- normalize(r_a - (tau/2) V(r_m)/a); departure =
        arrival reflected through the midpoint (exact great-circle).
        """
        K = u.shape[0]
        e = self.e[:, None]
        n = self.n[:, None]
        r_a = jnp.broadcast_to(self.r[:, None],
                               (3, K, self.nlat, self.nlon))
        V3 = u[None] * e + v[None] * n                    # [3, K, ...]
        s = half_tau / radius
        # first guess: winds at the arrival point
        r_m = r_a - s * V3
        r_m = r_m / jnp.linalg.norm(r_m, axis=0, keepdims=True)
        for _ in range(max(iters - 1, 0)):
            lam_m, phi_m = self._angles(r_m)
            Vm = self.interp(V3, lam_m, phi_m, cubic=False)
            # keep the interpolated wind tangent at the midpoint
            Vm = Vm - jnp.sum(Vm * r_m, axis=0, keepdims=True) * r_m
            r_m = r_a - s * Vm
            r_m = r_m / jnp.linalg.norm(r_m, axis=0, keepdims=True)
        lam_m, phi_m = self._angles(r_m)
        dot = jnp.sum(r_a * r_m, axis=0, keepdims=True)
        r_d = 2.0 * dot * r_m - r_a
        lam_d, phi_d = self._angles(r_d)
        return (lam_d, phi_d), (lam_m, phi_m)


def _stack(*fields):
    return jnp.stack(fields, axis=0)


def _coriolis_inverse(W, r3, a):
    """Solve V + a (r x V) = W analytically for tangent V (W tangent).

    The arrival half of the TRAPEZOIDAL Coriolis treatment along the
    trajectory: unconditionally stable in f dt (an explicit midpoint
    Coriolis term goes unstable once f dt > 1, which TL639-class steps
    approach at the poles), and exactly preserves a resting atmosphere.
    """
    rxW = jnp.cross(r3, W, axis=0)
    return (W - a * rxW) / (1.0 + a * a)


def sl_trajectories(sht, vc, slg: SLGrid, now, tau):
    """Trajectory angles from the arrival-time winds: 3-D great-circle
    departure/midpoint pairs plus the 2-D pair of the mass-weighted mean
    wind (continuity: d(lnps)/dt following ubar = -sum_k dpt_k D_k).

    Its own device program in the low-memory split mode: the midpoint
    wind interpolation's banded-window working set and the departure
    stack's transform temporaries must not be co-resident at TL639/L60
    (fused, sl_prep_dep alone needs ~16.6 GB on a 15.75 GB chip).
    """
    h = tau / 2.0
    a = sht.radius
    _P = jax.lax.Precision.HIGHEST
    u, v = sht.uv_from_vort_div(now.vort, now.div)
    wbar = vc.dB if vc.hybrid else vc.ds
    (lam_d, phi_d), (lam_m, phi_m) = slg.trajectories(u, v, h, a)
    ubar = jnp.einsum("k,kij->ij", wbar, u, precision=_P)[None]
    vbar = jnp.einsum("k,kij->ij", wbar, v, precision=_P)[None]
    (lam_d2, phi_d2), (lam_m2, phi_m2) = slg.trajectories(ubar, vbar, h, a)
    return {"angd": (lam_d, phi_d, lam_d2, phi_d2),
            "angm": (lam_m, phi_m, lam_m2, phi_m2)}


def sl_dep_stack(sht, vc, slg: SLGrid, now, prev, tau, decenter=0.1,
                 coriolis="midpoint"):
    """The departure-time combined-field stack X- + h (L X)- (NO
    trajectories, NO interpolation, NO midpoint terms). Own device
    program in split mode (see sl_trajectories)."""
    L = vc.nlev
    h = tau / 2.0
    hd = (1.0 - decenter) * h          # explicit / departure half
    _P = jax.lax.Precision.HIGHEST

    gp = dycore.to_grid(sht, vc, prev, diag=False)   # departure-time fields

    # ---- departure-time combined fields  X- + h (L X)-  ------------------
    # gamma = G T + R Tref pi (the implicitly-treated geopotential head)
    gamma_p = (jnp.einsum("kj,j...->k...", vc.G.astype(prev.T.dtype), prev.T,
                          precision=_P)
               + c.rd * vc.tref * prev.lnps[None])
    dgx_p, dgy_p = sht.grad(gamma_p)                     # [L, nlat, nlon]
    WD_p = sht.synthesize(jnp.einsum("kj,j...->k...",
                                     vc.W.astype(prev.div.dtype), prev.div,
                                     precision=_P))
    bD_p = sht.synthesize(jnp.einsum("j,j...->...",
                                     vc.b.astype(prev.div.dtype), prev.div,
                                     precision=_P))
    e3, n3 = slg.e[:, None], slg.n[:, None]
    r3 = slg.r[:, None]
    # Coriolis parameter as a grid field (traditional approximation,
    # matching the Eulerian path)
    fcor = 2.0 * c.omega * slg.r[2][None]                # [1, nlat, nlon]
    V3_p = gp.u[None] * e3 + gp.v[None] * n3             # [3, L, ...]
    grad_gamma_p3 = dgx_p[None] * e3 + dgy_p[None] * n3
    if coriolis == "trapezoid":
        # half the rotation at the departure point (folded into the
        # interpolated field), half implicitly at arrival
        # (_coriolis_inverse). Unconditionally stable in f dt, but see
        # the `coriolis` docstring in sl_step: the splitting against the
        # semi-implicit gravity terms detunes Rossby-wave balance and
        # damps synoptic eddies at ~0.5%/step at T42/dt=1800.
        V3_comb = (V3_p - h * fcor[None] * jnp.cross(r3, V3_p, axis=0)
                   - hd * grad_gamma_p3)                 # + h Cor + hd L
    else:
        # "midpoint": Coriolis joins the explicit nonlinear terms,
        # centered in time at t (the middle of the 3TL window) and in
        # space at the trajectory midpoint — the IFS-lineage default.
        V3_comb = V3_p - hd * grad_gamma_p3
    T_comb = gp.T + hd * WD_p
    pi_comb = gp.lnps[None] - hd * bD_p[None]            # [1, nlat, nlon]

    # ---- departure field stack -------------------------------------------
    dep_fields = jnp.concatenate([
        V3_comb,                                  # 3 x [L]
        _stack(T_comb, gp.q, gp.ql, gp.qi, gp.a).reshape(5, L, slg.nlat,
                                                         slg.nlon),
    ], axis=0)                                    # [8, L, nlat, nlon]

    return {"dep": dep_fields, "pi_comb": pi_comb}


def sl_prep_dep(sht, vc, slg: SLGrid, now, prev, tau, decenter=0.1,
                coriolis="midpoint"):
    """Departure side of the SL step: trajectories + the departure-time
    combined-field stack (the fused-path composition of sl_trajectories
    + sl_dep_stack; split mode runs them as separate programs)."""
    out = sl_dep_stack(sht, vc, slg, now, prev, tau, decenter, coriolis)
    out.update(sl_trajectories(sht, vc, slg, now, tau))
    return out


def sl_mid_grid(sht, vc, slg: SLGrid, now):
    """Grid-view half of the midpoint prep: arrival-time grid fields,
    surface-pressure gradients, vertical velocity, and the geopotential
    spectrum. Own device program in split mode — fused, sl_prep_mid's
    HLO temp is 8.5 GB at TL639/L60 (scripts/tl639_mem.py), which on top
    of the steady-state now+prev spectral pair exceeds a 16 GB chip."""
    _P = jax.lax.Precision.HIGHEST
    dtype = now.T.dtype

    g = dycore.to_grid(sht, vc, now)          # arrival-time fields
    dpx, dpy = sht.grad(now.lnps)

    # ---- vertical velocity + hybrid coefficients at time t ---------------
    hc = dycore._hybrid_coeffs_grid(vc, g.lnps)
    vgrad = g.u * dpx[None] + g.v * dpy[None]
    if hc is None:
        ds = vc.ds[:, None, None]
        Ct = (g.div + vgrad) * ds
        dpt = None
        dpt_full = ds
        Bh = vc.sh
        wp = 1.0
    else:
        dpt = hc["dpt"]
        dpt_full = dpt
        Ct = g.div * dpt + vc.dB[:, None, None] * vgrad
        Bh = vc.B
        wp = hc["wp"]
    csum = jnp.cumsum(Ct, axis=0)
    total = csum[-1:]
    sdot_int = Bh[1:-1, None, None] * total - csum[:-1]
    zero = jnp.zeros_like(sdot_int[:1])
    sdot = jnp.concatenate([zero, sdot_int, zero], axis=0)

    if hc is None:
        phi_spec = jnp.einsum("kj,j...->k...", vc.G.astype(dtype),
                              now.T, precision=_P)
    else:
        T_last = jnp.moveaxis(g.T, 0, -1)
        phi_grid = vc.geopotential_full(
            T_last, lnr=jnp.moveaxis(hc["lnr"], 0, -1),
            alpha=jnp.moveaxis(hc["alpha"], 0, -1))
        phi_spec = sht.analyze(jnp.moveaxis(phi_grid, -1, 0)).astype(
            dtype)
    return {"u": g.u, "v": g.v, "T": g.T, "q": g.q, "ql": g.ql,
            "qi": g.qi, "a": g.a, "div": g.div, "omega_p": g.omega_p,
            "sdot": sdot, "dpt": dpt, "dpt_full": dpt_full, "wp": wp,
            "dpx": dpx, "dpy": dpy, "phi_spec": phi_spec}


def sl_mid_terms(sht, vc, slg: SLGrid, now, m, coriolis="midpoint"):
    """N-term half of the midpoint prep: assemble the explicit nonlinear
    terms N(t) from the grid-view bundle ``m`` (sl_mid_grid)."""
    L = vc.nlev
    _P = jax.lax.Precision.HIGHEST
    dtype = now.T.dtype
    e3, n3 = slg.e[:, None], slg.n[:, None]
    r3 = slg.r[:, None]
    fcor = 2.0 * c.omega * slg.r[2][None]                # [1, nlat, nlon]
    sdot, dpt, dpt_full, wp = m["sdot"], m["dpt"], m["dpt_full"], m["wp"]
    dpx, dpy = m["dpx"], m["dpy"]

    # ---- midpoint nonlinear terms N(t) -----------------------------------
    # momentum: N_V = -vertadv(V) - Rd T wp grad(pi) - grad(Phi)
    #                 + grad(gamma)   (Coriolis is in the trapezoid)
    dphx, dphy = sht.grad(m["phi_spec"])
    gamma_n = (jnp.einsum("kj,j...->k...", vc.G.astype(dtype), now.T,
                          precision=_P)
               + c.rd * vc.tref * now.lnps[None])
    dgx_n, dgy_n = sht.grad(gamma_n)
    # full PGF = -Rd T wp grad(pi) - grad(Phi); adding grad(gamma) leaves
    # the explicit residual (the Tref parts cancel exactly on sigma)
    Fx = -c.rd * m["T"] * wp * dpx[None] - dphx + dgx_n
    Fy = -c.rd * m["T"] * wp * dpy[None] - dphy + dgy_n
    adv_u = dycore._vert_advect(vc, sdot, m["u"], dpt)
    adv_v = dycore._vert_advect(vc, sdot, m["v"], dpt)
    N_V3 = (-(adv_u[None] * e3 + adv_v[None] * n3)
            + Fx[None] * e3 + Fy[None] * n3)
    if coriolis != "trapezoid":
        # centered-midpoint Coriolis: -f r x V(t), interpolated linearly
        # at the trajectory midpoint with the rest of N. Stable for
        # f tau < 2 (dt below ~1.9 h even at the poles) and — unlike the
        # trapezoid — consistent in time with the midpoint PGF, so a
        # balanced Rossby wave stays balanced instead of shedding
        # gravity waves each step (rot-wave test: trapezoid damps an
        # m=8 wave at 0.5%/step; midpoint at the pure-interpolation
        # 0.04%/step).
        V3_n = m["u"][None] * e3 + m["v"][None] * n3
        N_V3 = N_V3 - fcor[None] * jnp.cross(r3, V3_n, axis=0)

    # T: N_T = kappa T omega/p - vertadv(T) - W D
    WD_n = sht.synthesize(jnp.einsum("kj,j...->k...",
                                     vc.W.astype(dtype), now.div,
                                     precision=_P))
    N_T = (c.kappa * m["T"] * m["omega_p"]
           - dycore._vert_advect(vc, sdot, m["T"], dpt) - WD_n)

    # lnps: N_pi = -sum_k dpt_k D_k + b.D  (zero on pure sigma at the
    # reference state; nonzero through the actual hybrid thicknesses)
    bD_n = sht.synthesize(jnp.einsum("j,j...->...",
                                     vc.b.astype(dtype), now.div,
                                     precision=_P))
    N_pi = (-jnp.sum(dpt_full * m["div"], axis=0) + bD_n)[None]

    # tracers: only vertical advection is explicit (horizontal transport
    # IS the trajectory)
    N_q = -dycore._vert_advect(vc, sdot, m["q"], dpt)
    N_ql = -dycore._vert_advect(vc, sdot, m["ql"], dpt)
    N_qi = -dycore._vert_advect(vc, sdot, m["qi"], dpt)
    N_a = -dycore._vert_advect(vc, sdot, m["a"], dpt)

    # ---- midpoint field stack --------------------------------------------
    mid_fields = jnp.concatenate([
        N_V3,
        _stack(N_T, N_q, N_ql, N_qi, N_a).reshape(5, L, slg.nlat, slg.nlon),
    ], axis=0)

    return {"mid": mid_fields, "N_pi": N_pi}


def sl_prep_mid(sht, vc, slg: SLGrid, now, tau, coriolis="midpoint"):
    """Midpoint side of the SL step: the explicit nonlinear terms N(t)
    on the grid (the fused composition of sl_mid_grid + sl_mid_terms;
    split mode runs them as separate device programs). ``tau`` is
    accepted for signature stability (N(t) does not depend on it)."""
    del tau
    m = sl_mid_grid(sht, vc, slg, now)
    return sl_mid_terms(sht, vc, slg, now, m, coriolis)


def sl_prep(sht, vc, slg: SLGrid, now, prev, tau, decenter=0.1,
            coriolis="midpoint"):
    """Both prep halves (the fused-path composition)."""
    prep = sl_prep_dep(sht, vc, slg, now, prev, tau, decenter, coriolis)
    prep.update(sl_prep_mid(sht, vc, slg, now, tau, coriolis))
    return prep


def sl_interp_dep(slg: SLGrid, dep_fields, pi_comb, lam_d, phi_d,
                  lam_d2, phi_d2, blocks=False):
    """Departure-point (cubic) interpolation of the combined fields.
    Its own device program in split mode: the gather working set and
    sl_finish's must not be co-resident at TL639/L60. ``blocks=True``
    returns dep_vals in the level-chunked layout (see SLGrid.interp)."""
    dep_vals = slg.interp(dep_fields, lam_d, phi_d, cubic=True,
                          out_blocks=blocks)
    # pi is 2-D: fields [F=1, K=1, nlat, nlon], targets [K=1, nlat, nlon]
    pi_dep = slg.interp(pi_comb[None], lam_d2, phi_d2, cubic=True)
    return dep_vals, pi_dep


def sl_arrivals(slg: SLGrid, mid_fields, N_pi, lam_m, phi_m,
                lam_m2, phi_m2, dep_vals, pi_dep, tau,
                coriolis="midpoint"):
    """Midpoint (linear) interpolation + arrival-point combination and
    Coriolis inverse — the grid-space half of sl_finish. Own device
    program in split mode: its interpolation working set and the solve
    half's transform temporaries must not be co-resident at TL639/L60."""
    h = tau / 2.0
    e3, n3 = slg.e[:, None], slg.n[:, None]
    r3 = slg.r[:, None]
    fcor = 2.0 * c.omega * slg.r[2][None]                # [1, nlat, nlon]

    # Sequence the midpoint gather working set after the departure one
    # (meaningful in the fused path; a no-op ordering when sl_interp_dep
    # ran as its own program). Identity on values.
    (mid_fields, N_pi, lam_m, phi_m, lam_m2, phi_m2,
     dep_vals, pi_dep) = jax.lax.optimization_barrier(
        (mid_fields, N_pi, lam_m, phi_m, lam_m2, phi_m2,
         dep_vals, pi_dep))

    def combine(mid_b, dep_b, lam_b, phi_b):
        """Midpoint (linear) interpolation + arrival combination for one
        level block (levels are independent)."""
        mid_vals = slg.interp(mid_b, lam_b, phi_b, cubic=False)
        W3 = dep_b[:3] + tau * mid_vals[:3]
        # tangent projection at the arrival point (removes the
        # constraint component); under the trapezoid treatment the
        # implicit arrival half of the Coriolis rotation follows
        W3 = W3 - jnp.sum(W3 * r3, axis=0, keepdims=True) * r3
        if coriolis == "trapezoid":
            V3_t = _coriolis_inverse(W3, r3, h * fcor[None])
        else:
            V3_t = W3
        u_t = jnp.sum(V3_t * e3, axis=0)
        v_t = jnp.sum(V3_t * n3, axis=0)
        arrived = dep_b[3:] + tau * mid_vals[3:]
        return jnp.concatenate(
            [u_t[None], v_t[None], arrived], axis=0)   # [7, kc, ...]

    kc = getattr(slg, "k_chunk", None)
    K = lam_m.shape[0]
    blocked = dep_vals.ndim == 5          # [nb, 8, kc, nlat, nlon]
    if blocked or (kc and K > kc and K % kc == 0):
        # level-chunk the whole interp+combine (low-memory mode): the
        # full-size midpoint-interp output never materializes; a blocked
        # dep_vals (sl_interp_dep blocks=True) is consumed natively as
        # the scan xs — no de-blocking transpose on either side
        kcb = dep_vals.shape[2] if blocked else kc
        nb = K // kcb

        def body(_, xs):
            i, dep_b = xs
            if dep_b is None:
                dep_b = jax.lax.dynamic_slice_in_dim(dep_vals, i * kcb,
                                                     kcb, axis=1)
            mid_b = jax.lax.dynamic_slice_in_dim(mid_fields, i * kcb,
                                                 kcb, axis=1)
            lam_b = jax.lax.dynamic_slice_in_dim(lam_m, i * kcb, kcb,
                                                 axis=0)
            phi_b = jax.lax.dynamic_slice_in_dim(phi_m, i * kcb, kcb,
                                                 axis=0)
            return None, combine(mid_b, dep_b, lam_b, phi_b)

        idx = jnp.arange(nb, dtype=jnp.int32)
        if blocked:
            _, out = jax.lax.scan(
                lambda c, xs: body(c, xs), None, (idx, dep_vals))
        else:
            _, out = jax.lax.scan(
                lambda c, i: body(c, (i, None)), None, idx)
        out = jnp.swapaxes(out, 0, 1).reshape(7, K, slg.nlat, slg.nlon)
    else:
        out = combine(mid_fields, dep_vals, lam_m, phi_m)
    u_t, v_t, T_t, q_t, ql_t, qi_t, a_t = [out[i] for i in range(7)]

    pi_mid = slg.interp(N_pi[None], lam_m2, phi_m2, cubic=False)
    pi_t = (pi_dep + tau * pi_mid)[0, 0]
    return u_t, v_t, T_t, q_t, ql_t, qi_t, a_t, pi_t


def sl_solve(sht, vc, u_t, v_t, T_t, q_t, ql_t, qi_t, a_t, pi_t, tau,
             decenter=0.1):
    """Spectral analysis of the arrival fields + the off-centered
    semi-implicit solve — the spectral half of sl_finish."""
    h = tau / 2.0
    ha = (1.0 + decenter) * h          # implicit / arrival half
    _P = jax.lax.Precision.HIGHEST
    dtype = T_t.dtype

    # ---- spectral analysis + semi-implicit solve at arrival ---------------
    vort_new, D_tilde = sht.vort_div_from_uv(u_t, v_t)
    T_tilde = sht.analyze(T_t).astype(dtype)
    pi_tilde = sht.analyze(pi_t).astype(dtype)

    Minv = vc.implicit_inverse(ha, sht.trunc)
    lam_op = (-sht.laplacian)[..., None]                 # +n(n+1)/a^2
    rhs = D_tilde + ha * lam_op[None] * (
        jnp.einsum("kj,j...->k...", vc.G.astype(T_tilde.dtype), T_tilde,
                   precision=_P)
        + c.rd * vc.tref * pi_tilde[None])
    div_new = jnp.einsum("nlj,jmnc->lmnc", Minv.astype(rhs.dtype), rhs,
                         precision=_P)
    T_new = T_tilde + ha * jnp.einsum("kj,j...->k...",
                                      vc.W.astype(div_new.dtype), div_new,
                                      precision=_P)
    pi_new = pi_tilde - ha * jnp.einsum("j,j...->...",
                                        vc.b.astype(div_new.dtype), div_new,
                                        precision=_P)

    mask = sht.mask[..., None]
    return dycore.SpectralState(
        vort=vort_new * mask, div=div_new * mask, T=T_new * mask,
        lnps=pi_new * mask,
        q=sht.analyze(q_t).astype(dtype),
        ql=sht.analyze(ql_t).astype(dtype),
        qi=sht.analyze(qi_t).astype(dtype),
        a=sht.analyze(a_t).astype(dtype))


def sl_finish(sht, vc, slg: SLGrid, mid_fields, N_pi, lam_m, phi_m,
              lam_m2, phi_m2, dep_vals, pi_dep, tau, decenter=0.1,
              coriolis="midpoint"):
    """Midpoint interpolation + arrival combination + semi-implicit
    solve (the fused-path composition of sl_arrivals + sl_solve)."""
    arr = sl_arrivals(slg, mid_fields, N_pi, lam_m, phi_m, lam_m2,
                      phi_m2, dep_vals, pi_dep, tau, coriolis)
    return sl_solve(sht, vc, *arr, tau, decenter=decenter)


def sl_step(sht, vc, slg: SLGrid, now, prev, tau, decenter=0.1,
            coriolis="midpoint"):
    """One 3TL semi-Lagrangian semi-implicit step: prev -> new over tau.

    Replaces dycore.tendencies + semi_implicit_step when
    GCMConfig.advection == "sl". Same prognostics, same SI matrices
    (vertical.py), same downstream hyperdiffusion/Robert filter.
    Composition of sl_prep -> sl_interp_dep -> sl_finish (three device
    programs under GCMConfig.split_phases; fused into one otherwise).

    ``decenter``: first-order off-centering of the semi-implicit GRAVITY
    terms — the implicit (arrival) half-weight is (1+eps) h, the
    explicit (departure) half-weight (1-eps) h. A CENTERED 3TL SL-SI
    scheme supports a slowly-amplifying spurious gravity-wave resonance;
    in the HS94 T42/L19 climatology it grows from the model top at the
    poles until NaN near day 47 REGARDLESS of vertical coordinate or
    lnps diffusion (round-4 bisection: sigma and hybrid blow up
    identically, Eulerian is stable). Off-centering is the standard
    IFS-lineage remedy and damps exactly this mode.

    ``coriolis``: "midpoint" (default) evaluates -f r x V with the
    explicit nonlinear terms, centered in time; "trapezoid" splits the
    rotation into an explicit departure half and an implicit arrival
    half (unconditionally stable in f dt, but time-split against the
    semi-implicit gravity terms: a balanced Rossby wave sheds gravity
    waves each step and synoptic eddies damp at ~0.5%/step at
    T42/dt=1800 — the round-4 Held-Suarez 10 m/s-jet failure. The
    midpoint form is stable for f tau < 2, i.e. dt below ~1.9 h even at
    the poles, which covers every target configuration).
    """
    prep = sl_prep(sht, vc, slg, now, prev, tau, decenter, coriolis)
    dep_vals, pi_dep = sl_interp_dep(slg, prep["dep"], prep["pi_comb"],
                                     *prep["angd"])
    return sl_finish(sht, vc, slg, prep["mid"], prep["N_pi"],
                     *prep["angm"], dep_vals, pi_dep, tau, decenter,
                     coriolis)

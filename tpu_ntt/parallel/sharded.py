"""Mesh-sharded transforms: the pod-scale NTT.

The reference scales its transform two ways (SURVEY.md §5): more PEs per
chip (bank crossbar + brscramble permutation network,
``AddressGenerator.v:310-337``) and bigger rings by macro change.  Across
chips there is nothing — PCIe to one FPGA is the end of the line.

Here large transforms shard over a ``jax.sharding.Mesh`` axis and the
butterfly-stage exchange becomes a single ``all_to_all`` (matrix
transpose), via the classic **four-step/Bailey decomposition** n = n1·n2:

1. view coefficients as an (n1, n2) matrix, n2 (columns) sharded;
2. size-n1 NTTs down the columns — local (contraction axis unsharded),
   with the negacyclic twist factor ψ^(n2·i1) merged into the stage
   twiddles (valid: ψ^n2 is a primitive 2n1-th root);
3. elementwise twist ψ^i2 · ω^(i2·k1) — local, precomputed in the same
   bit-reversed k1 order the column NTT emits (no unscrambling);
4. ``all_to_all`` transpose (the interconnect's replacement for the
   FPGA's brscramble crossbar — one collective for all log(n) stages);
5. size-n2 NTTs along the rows — local, plain cyclic.

The spectrum comes out in "four-step order" (bit-reversed per factor ×
transposed) — order-agnostic for pointwise products, exactly like the
reference keeping its spectrum bit-reversed between NTT and INTT
(PolyMult.v:222-227).  The inverse mirrors each step, with every scale
(n1⁻¹·n2⁻¹, Montgomery fix) folded into the single un-twist table.

Works on any mesh the axis divides: 8 virtual host devices, one GPU
(D=1), the GPUs of one host, or several hosts (build the mesh over DCN with
``jax.distributed.initialize`` — see ``multihost.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import NTTParams, modinv
from ..transform import Plan

__all__ = ["ShardedPlan", "make_mesh", "make_mesh_hier", "mesh_axes",
           "dp_polymul"]


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    """1-D device mesh over the first n_devices local devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), (axis,))


def make_mesh_hier(d1: int, d2: int,
                   axes: tuple[str, str] = ("sp1", "sp2")) -> Mesh:
    """2-D sequence-parallel mesh (d1, d2) for the hierarchical
    exchange: one all_to_all per axis instead of one over all devices."""
    devs = jax.devices()
    if d1 * d2 > len(devs):
        raise ValueError(f"need {d1 * d2} devices, have {len(devs)}")
    return Mesh(np.array(devs[:d1 * d2]).reshape(d1, d2), axes)


def mesh_axes(mesh: Mesh):
    """(transform axis, batch axis or None) of a mesh.

    The transform runs over ("sp1", "sp2") when both are named (the
    hierarchical exchange), else "x", else "sp", else the last axis that
    is not "dp".  A "dp" axis shards the batch and never carries the
    transform."""
    names = list(mesh.shape)
    if "sp1" in names and "sp2" in names:
        axis = ("sp1", "sp2")
    elif "x" in names:
        axis = "x"
    elif "sp" in names:
        axis = "sp"
    else:
        non_dp = [nm for nm in names if nm != "dp"]
        if not non_dp:
            raise ValueError(
                "mesh has only a 'dp' axis — a dp axis shards the batch, "
                "never the transform; use parallel.sharded.dp_polymul for "
                "pure data parallelism, or name a transform axis 'x'/'sp'")
        axis = non_dp[-1]
    return axis, ("dp" if "dp" in names else None)


def dp_polymul(plan, mesh: Mesh, axis: str = "dp"):
    """Data-parallel wrapper: run any per-chip polymul backend (Plan,
    PallasPolymul, PallasIncompletePolymul, MatmulNTT) on each device's
    local batch shard — no cross-device communication at all, the
    throughput-scaling mode for small rings (each chip is the whole FPGA).

    Returns a jitted ``f(a, b)`` over ``(batch, n)`` arrays whose batch
    axis is (or will be) sharded over ``axis``.  batch must divide by the
    axis size.
    """
    spec = P(axis, None)

    def f(a, b):
        return plan.polymul(a, b)

    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=spec, check_vma=False))


@dataclasses.dataclass(frozen=True)
class _Split:
    n1: int
    n2: int


def _choose_split(n: int, d: int) -> _Split:
    """n = n1·n2 with d | n1 and d | n2, both as square as possible."""
    l = n.bit_length() - 1
    l2 = l // 2
    n1, n2 = 1 << (l - l2), 1 << l2
    if n1 % d or n2 % d:
        raise ValueError(f"mesh size {d} must divide both factors of "
                         f"n={n} (got {n1}x{n2})")
    return _Split(n1, n2)


class ShardedPlan:
    """Four-step transform plan over a 1-D mesh axis — or a HIERARCHICAL
    multi-axis sp mesh (``axis`` a tuple of names).

    API parity with :class:`~tpu_ntt.transform.Plan` at pod scale:
    ``forward``/``inverse``/``pointwise``/``polymul``, all operating on
    ``(batch, n)`` arrays whose coefficient axis is sharded.

    **Hierarchical mode** (``axis=("sp1", "sp2")``): the four-step
    transpose decomposes into one ``all_to_all`` per mesh axis, innermost
    first — each a collective over a group of D1 or D2 devices instead of
    one over all D.  Whether that pays on a given interconnect is a
    measurement (``chip_smoke.py --four`` times both forms).  The algebra
    costs nothing: after the per-axis exchanges each device holds its
    rows in a layout that is exactly the sharding over the REVERSED axes
    tuple with columns contiguous in natural order, so the spectrum spec
    is ``P(batch, (sp2, sp1), None)`` and no local permutation exists
    anywhere.  This is the mesh re-expression of the reference's
    brscramble network scaling with PE_DEPTH (AddressGenerator.v:310-337)
    past a single ring of 8.
    """

    def __init__(self, params: NTTParams, mesh: Mesh,
                 axis: str | tuple[str, ...] = "x",
                 n1: int | None = None, batch_axis: str | None = None):
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.axes = (axis,) if isinstance(axis, str) else tuple(axis)
        self.batch_axis = batch_axis   # optional data-parallel mesh axis
        d = 1
        for ax in self.axes:
            d *= mesh.shape[ax]
        self.d = d
        if n1 is None:
            split = _choose_split(params.n, d)
        else:
            split = _Split(n1, params.n // n1)
            if split.n1 % d or split.n2 % d:
                raise ValueError("mesh size must divide both n1 and n2")
        self.n1, self.n2 = split.n1, split.n2
        p, q = params, params.q

        # column sub-transform: size n1, root omega^n2, twist psi^n2
        om1 = pow(p.omega, self.n2, q)
        psi1 = pow(p.psi, self.n2, q) if p.psi else 0
        self.plan1 = Plan(NTTParams(n=self.n1, q=q, omega=om1, psi=psi1))
        # row sub-transform: size n2, root omega^n1, cyclic (twist consumed)
        om2 = pow(p.omega, self.n1, q)
        self.plan2 = Plan(NTTParams(n=self.n2, q=q, omega=om2, psi=0))
        self.arith = self.plan1.arith

        self._twiddles()

    # ------------------------------------------------------------------

    def _twiddles(self):
        """The step-3 twist tables, in (i2, k1_bitrev) orientation,
        host-side numpy; fwd: psi^i2 · omega^(i2·k1);
        inv: psi^-i2 · omega^(-i2·k1) · n^-1 · pointwise_fix."""
        from ..utils.bitrev import bit_reverse_indices
        p = self.params
        q = p.q
        n1, n2 = self.n1, self.n2

        def powers(base: int, count: int) -> np.ndarray:
            out = np.empty(count, dtype=np.int64)
            acc = 1
            for i in range(count):
                out[i] = acc
                acc = acc * base % q
            return out

        k1 = bit_reverse_indices(n1)            # position -> true frequency
        exp = (np.arange(n2, dtype=np.int64)[:, None] * k1[None, :]) % p.n
        psi = p.psi if p.psi else 1
        psi_inv = modinv(psi, q) if p.psi else 1
        w_pow = powers(p.omega, p.n)
        wi_pow = powers(p.omega_inv, p.n)
        psi_col = powers(psi, n2)[:, None]
        psi_inv_col = powers(psi_inv, n2)[:, None]
        inv_scale = modinv(p.n, q) * self.arith.pointwise_fix % q

        fwd = psi_col * w_pow[exp] % q
        inv = psi_inv_col * wi_pow[exp] % q * inv_scale % q
        self._t_fwd = self.arith.const_table(fwd)
        self._t_inv = self.arith.const_table(inv)

    def _local_tw(self, tab, idx):
        """Slice a (n2, n1) table to this device's i2 range."""
        l2 = self.n2 // self.d
        return tuple(jax.lax.dynamic_slice_in_dim(jnp.asarray(t), idx * l2,
                                                  l2, axis=0) for t in tab)

    # ------------------------------------------------------------------
    # shard_map bodies (operate on local blocks, batch leading)
    # ------------------------------------------------------------------

    def _axis_index(self):
        """Global column-block index of this device: lexicographic over
        the (possibly hierarchical) transform axes."""
        idx = jax.lax.axis_index(self.axes[0])
        for ax in self.axes[1:]:
            idx = idx * self.mesh.shape[ax] + jax.lax.axis_index(ax)
        return idx

    def _fwd_local(self, x):
        """Forward phase 1 (all LOCAL work before the collective):
        column NTTs + twist on (B, n1, L2)."""
        idx = self._axis_index()
        y = jnp.swapaxes(x, -1, -2)                       # (B, L2, n1)
        y = self.plan1.ntt(y, "ct", "std2rev",
                           mixed=self.params.negacyclic)  # column NTTs
        y = self.arith.mul_const(y, self._local_tw(self._t_fwd, idx))
        return jnp.swapaxes(y, -1, -2)                    # (B, n1, L2)

    def _fwd_a2a(self, y):
        """Forward phase 2: the interconnect transpose (brscramble analog).

        Hierarchical: one all_to_all per axis, INNERMOST first.  After
        exchanging over the innermost axis the received column blocks of
        one outer-group are contiguous in natural order; the outer
        exchange then concatenates whole group slabs, so columns come
        out globally natural and the rows land sharded over the
        REVERSED axes tuple (see spec_spec) — no local fix-up."""
        for ax in reversed(self.axes):
            y = jax.lax.all_to_all(y, ax, split_axis=1,
                                   concat_axis=2, tiled=True)
        return y

    def _fwd_rows(self, y):
        """Forward phase 3 (local): row NTTs on (B, n1/D, n2)."""
        return self.plan2.ntt(y, "ct", "std2rev")

    def _fwd_body(self, x):
        """x local: (B, n1, L2) — coefficient matrix with columns sharded."""
        return self._fwd_rows(self._fwd_a2a(self._fwd_local(x)))

    def _inv_rows(self, y):
        """Inverse phase 1 (local): row INTTs on the spectrum."""
        return self.plan2.ntt(y, "gs", "rev2std", inverse=True)

    def _inv_a2a(self, z):
        """Mirror of _fwd_a2a: per-axis inverse exchanges, outermost
        first (exact inverse of the forward composition)."""
        for ax in self.axes:
            z = jax.lax.all_to_all(z, ax, split_axis=2,
                                   concat_axis=1, tiled=True)
        return z

    def _inv_finish(self, z):
        """Inverse phase 3 (local): untwist + column INTTs."""
        idx = self._axis_index()
        z = jnp.swapaxes(z, -1, -2)                       # (B, L2, n1)
        z = self.arith.mul_const(z, self._local_tw(self._t_inv, idx))
        z = self.plan1.ntt(z, "gs", "rev2std", inverse=True,
                           mixed=self.params.negacyclic)
        return jnp.swapaxes(z, -1, -2)                    # (B, n1, L2)

    def _inv_body(self, y):
        """y local: (B, n1/D, n2) four-step spectrum -> (B, n1, L2)."""
        return self._inv_finish(self._inv_a2a(self._inv_rows(y)))

    def _polymul_body(self, a, b):
        # both forward transforms ride ONE all_to_all (the forward body
        # is batch-elementwise, so stacking a and b along the batch axis
        # halves the per-product collective count: 2 instead of 3 —
        # same bytes, fewer latency terms on the collective critical path)
        B = a.shape[0]
        fab = self._fwd_body(jnp.concatenate([a, b], axis=0))
        return self._inv_body(self.arith.mul(fab[:B], fab[B:]))

    def _chain_body(self, stacked, k):
        """Chained products ((a·b1)·b2)…·bk with the middle products
        consumed in the transposed spectral (four-step) orientation: the
        inverse transpose of product i and the forward transposes of
        product i+1 cancel algebraically (T∘T⁻¹, NTT∘INTT, twist∘untwist
        pairs), so the whole chain is ONE stacked forward collective +
        k spectral pointwise products + ONE inverse collective — k_t
        drops from 3 to 2 transform-transposes per product asymptotically
        (SCALING.md §2).  ``stacked``: (B·(k+1), n1, L2) — a then
        b1..bk along the batch axis."""
        B = stacked.shape[0] // (k + 1)
        f = self._fwd_body(stacked)                       # 1 all_to_all
        acc = f[:B]
        for j in range(1, k + 1):
            acc = self.arith.mul(acc, f[j * B:(j + 1) * B])
        fix = self.arith.pointwise_fix
        if fix != 1 and k > 1:
            # each data×data mul carries fix^-1; the inverse untwist
            # table cancels exactly one — correct the other k-1
            corr = pow(fix, k - 1, self.params.q)
            acc = self.arith.mul_const(
                acc, self._chain_corr_tab(corr))
        return self._inv_body(acc)                        # 1 all_to_all

    def _chain_corr_tab(self, corr: int):
        # per-instance memo (an lru_cache on the method would pin self
        # in a class-level cache for the process lifetime)
        cache = self.__dict__.setdefault("_corr_tabs", {})
        if corr not in cache:
            cache[corr] = self.arith.const_table(
                np.array([corr], dtype=np.int64))
        return cache[corr]

    def _polymul_body_overlap(self, a, b):
        """Double-buffered polymul: the batch splits in halves and each
        half's all_to_all is issued before the other half's local
        transform work, so XLA's async collectives ride the interconnect
        transfer under the local compute.  Bit-exact
        with _polymul_body; 4 collectives of half volume instead of 2."""
        B = a.shape[0]
        if B < 2 or B % 2:
            raise ValueError(
                f"polymul_overlapped needs an even PER-SHARD batch to "
                f"double-buffer (got {B} rows on this shard; with a dp "
                f"batch axis the global batch must be divisible by "
                f"2·dp) — use polymul_jit for odd batches")
        h = B // 2
        s0 = jnp.concatenate([a[:h], b[:h]], axis=0)
        s1 = jnp.concatenate([a[h:], b[h:]], axis=0)
        l0 = self._fwd_local(s0)
        t0 = self._fwd_a2a(l0)          # in flight while s1 computes
        l1 = self._fwd_local(s1)
        t1 = self._fwd_a2a(l1)
        f0 = self._fwd_rows(t0)         # rides under t1
        f1 = self._fwd_rows(t1)
        p0 = self.arith.mul(f0[:h], f0[h:])
        p1 = self.arith.mul(f1[:h], f1[h:])
        z0 = self._inv_a2a(self._inv_rows(p0))
        z1s = self._inv_rows(p1)        # rides under z0
        z1 = self._inv_a2a(z1s)
        c0 = self._inv_finish(z0)       # rides under z1
        c1 = self._inv_finish(z1)
        return jnp.concatenate([c0, c1], axis=0)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def coef_spec(self):
        """PartitionSpec of a (batch, n1, n2) coefficient array:
        batch data-parallel (if batch_axis), coefficients sequence-parallel
        over the transform axis (joint lexicographic for hierarchical)."""
        ax = self.axes[0] if len(self.axes) == 1 else self.axes
        return P(self.batch_axis, None, ax)

    @property
    def spec_spec(self):
        """PartitionSpec of the four-step spectrum (batch, n1, n2).
        Hierarchical: the per-axis exchange leaves rows sharded over the
        REVERSED axes tuple (row chunk r' = d2·D1 + d1 lands on device
        (d1, d2)) — a pure relabeling the inverse path mirrors."""
        if len(self.axes) == 1:
            return P(self.batch_axis, self.axes[0], None)
        return P(self.batch_axis, tuple(reversed(self.axes)), None)

    def shard_coeffs(self, a):
        """Device-put a (batch, n) array as a sharded (batch, n1, n2)
        coefficient matrix — the device_put/DMA-staging analog."""
        from ..validation import check_domain
        check_domain(a, self.params.q, "shard_coeffs")
        a = np.asarray(a, dtype=np.int32).reshape(-1, self.n1, self.n2)
        return jax.device_put(
            a, NamedSharding(self.mesh, self.coef_spec))

    def unshard(self, c) -> np.ndarray:
        """Gather a (batch, n1, n2) result back to host (batch, n)."""
        return np.asarray(c).reshape(-1, self.params.n)

    def _smap(self, fn, in_specs, out_specs):
        return jax.jit(jax.shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    @functools.cached_property
    def forward_jit(self):
        return self._smap(self._fwd_body, (self.coef_spec,), self.spec_spec)

    @functools.cached_property
    def inverse_jit(self):
        return self._smap(self._inv_body, (self.spec_spec,), self.coef_spec)

    @functools.cached_property
    def polymul_jit(self):
        return self._smap(self._polymul_body,
                          (self.coef_spec, self.coef_spec), self.coef_spec)

    @functools.cached_property
    def polymul_overlapped_jit(self):
        """Double-buffered polymul (comm/compute overlap); batch must be
        even.  Bit-exact with ``polymul_jit``."""
        return self._smap(self._polymul_body_overlap,
                          (self.coef_spec, self.coef_spec), self.coef_spec)

    @property
    def chain_spec(self):
        """PartitionSpec of the (k+1, B, n1, n2) chain operand stack:
        operands on a NEW leading axis, batch on the dp axis — stacking
        along the batch axis instead would interleave different
        operands' rows across dp shards (caught by dryrun_multichip on
        the dp=2 x sp=4 mesh)."""
        ax = self.axes[0] if len(self.axes) == 1 else self.axes
        return P(None, self.batch_axis, None, ax)

    def polymul_chain_jit(self, k: int):
        """Jitted k-product chain: f(stacked) with ``stacked`` a
        (k+1, B, n1, n2) array (sharded per :attr:`chain_spec`) holding
        a, b1..bk on the leading axis; returns (B, n1, n2) =
        ((a·b1)·…)·bk.  2 collectives total vs 2k for repeated
        ``polymul_jit`` (volume (k+2)/3k)."""
        cache = self.__dict__.setdefault("_chain_jits", {})
        if k not in cache:
            def body(st):
                # local (k+1, B_loc, n1, L2) -> operand-major flat batch
                loc = st.reshape((k + 1) * st.shape[1], *st.shape[2:])
                return self._chain_body(loc, k)
            cache[k] = self._smap(body, (self.chain_spec,),
                                  self.coef_spec)
        return cache[k]

    def shard_chain(self, a, bs):
        """Device-put [a, b1..bk] as the (k+1, B, n1, n2) chain stack."""
        from ..validation import check_domain
        ops = [np.atleast_2d(np.asarray(a))] + [
            np.atleast_2d(np.asarray(b)) for b in bs]
        for i, x in enumerate(ops):
            check_domain(x, self.params.q, f"polymul_chain operand {i}")
        st = np.stack(ops).astype(np.int32).reshape(
            len(ops), -1, self.n1, self.n2)
        return jax.device_put(
            st, NamedSharding(self.mesh, self.chain_spec))

    def polymul_robust(self, a, b, *, deadline_s: float = 300.0,
                       attempts: int = 3, backoff_s: float = 5.0):
        """``polymul_jit`` with the failure detector wired in at pod
        scale: each attempt forces this process's addressable shards to
        completion under a :func:`~tpu_ntt.utils.watchdog.with_deadline`
        — so a PEER chip/process that wedges or dies mid-collective
        surfaces as :class:`~tpu_ntt.utils.watchdog.DeviceTimeout`
        within the deadline instead of hanging the job (the reference's
        busy/done-polling-timeout + reboot-after-wedge posture,
        ``NTT_PCIECommunicationv2.c:56-103``, at process scale).
        Returns the (possibly multi-process global) device array; use
        :meth:`unshard` on a single controller."""
        from ..utils.watchdog import retry

        def attempt():
            out = self.polymul_jit(a, b)
            for sh in out.addressable_shards:
                np.asarray(sh.data)       # force local completion
            return out

        return retry(attempt, attempts=attempts, timeout_s=deadline_s,
                     backoff_s=backoff_s)

    def polymul_chain(self, a, bs) -> np.ndarray:
        """Host-array chain convenience: ((a·bs[0])·bs[1])…, one stacked
        device_put in, unsharded product out."""
        k = len(bs)
        if k == 0:
            raise ValueError("polymul_chain needs at least one multiplier")
        return self.unshard(self.polymul_chain_jit(k)(
            self.shard_chain(a, bs)))

"""Fused NTT polynomial products for NVIDIA GPUs: one Pallas kernel
(Triton route) per batch of products.

:class:`~tpu_ntt.transform.Plan` expresses every butterfly stage as its
own reshape-and-slice XLA op over the whole batch, and XLA compiles a
product into several kernels that pass the batch between them through
device memory (``chip_smoke.py`` counts them).  Here one program owns a
tile of ``ROWS`` polynomials and runs both forward transforms, the
pointwise product and the inverse in one kernel: each operand is read
from device memory once and the product written once.  A stage is

    v = x.reshape(rows, blocks, 2, width)
    lo, hi = split(v, axis=2)                  # butterfly partners
    ... butterfly on (rows, blocks, 1, width) ...
    x = transpose(join(lo, hi), ...)           # back to (rows, n)

which Triton lowers to register shuffles and shared-memory exchanges; the
twiddles of a stage are one small load from a table in global memory.

The arithmetic is the plan's own (:mod:`tpu_ntt.ops.modmul`, chosen by
``select_arith(q)``), in the same order, so every output equals the
plan's bit for bit: :class:`FusedPolymul` wraps a :class:`Plan` (full
NTT) or an :class:`~tpu_ntt.schemes.IncompletePlan` with one missing level
(Kyber's ring), and tests compare the two exactly in interpret mode.

The kernel lowers only for GPUs.  Without a GPU it runs only with
an explicit ``interpret=True``, which the tests pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..params import stage_powers

__all__ = ["FusedPolymul", "supported", "MAX_N", "ROWS"]

# polynomials per program, and the warps that share them.  Chosen on an
# H100 at n=256 (see PERF.md); a tile of 16 x 256 int32 is 16 KiB.
ROWS = 16
NUM_WARPS = 4
# largest ring the kernel takes: a program holds ROWS x n values of each
# operand in registers, and past ~1024 points they spill
MAX_N = 1024


def supported(n: int, q: int, negacyclic: bool = True,
              levels: int = 0) -> bool:
    """True when the fused kernel covers this ring.

    ``levels=0`` is the full transform (needs q ≡ 1 mod 2n, or mod n for
    the cyclic ring); ``levels=1`` the incomplete one of
    :class:`~tpu_ntt.schemes.IncompletePlan` (negacyclic, q ≡ 1 mod n).
    q < 2^29 is the range of the plan's int32 arithmetic."""
    if n & (n - 1) or not 16 <= n <= MAX_N or not 2 < q < (1 << 29):
        return False
    if q % 2 == 0:
        return False
    if levels == 0:
        return (q - 1) % (2 * n if negacyclic else n) == 0
    return levels == 1 and negacyclic and (q - 1) % n == 0


def _require_gpu():
    from ..dispatch import current_platform
    if current_platform() != "gpu":
        raise RuntimeError(
            "the fused Pallas kernel runs only on a GPU; pass "
            "interpret=True to run it in the Pallas interpreter")


class FusedPolymul:
    """Fused kernels for the products of ``plan``.

    ``plan`` is a :class:`~tpu_ntt.transform.Plan` or an
    :class:`~tpu_ntt.schemes.IncompletePlan` with ``levels == 1``.  The
    transforms, the product and the module product have the plan's
    signatures and give the plan's results."""

    def __init__(self, plan, *, interpret: bool = False):
        from ..schemes import IncompletePlan
        if not interpret:
            _require_gpu()
        incomplete = isinstance(plan, IncompletePlan)
        self.levels = plan.levels if incomplete else 0
        sub = plan.sub if incomplete else plan
        p = sub.params
        self.n = p.n << self.levels
        self.q = p.q
        if not supported(self.n, self.q, p.negacyclic, self.levels):
            raise ValueError(
                f"the fused kernel does not cover n={self.n}, q={self.q}, "
                f"levels={self.levels} (see ops.fused.supported)")
        self.plan = plan
        self.sub = sub
        self.m = p.n
        self.arith = sub.arith
        self.interpret = interpret
        ar = self.arith
        # flat stage tables: stage with t twiddles reads entries [t, 2t)
        self._fwd = ar.const_table(stage_powers(
            p, p.omega, rev=True, psi_base=p.psi if p.negacyclic else 0))
        self._inv = ar.const_table(stage_powers(
            p, p.omega_inv, rev=True,
            psi_base=p.psi_inv if p.negacyclic else 0))
        scale = ar.const_table(np.array([p.n_inv * ar.pointwise_fix % p.q]))
        self._scale = tuple(c.dtype.type(c[0]) for c in scale)
        self._twist = plan._t if incomplete else ()

    # ------------------------------------------------------------------
    # in-kernel pieces: x is a (rows, m) tile, tables are refs
    # ------------------------------------------------------------------

    def _stages(self, x, refs, gs: bool):
        ar = self.arith
        rows, m = x.shape
        log2m = m.bit_length() - 1
        for s in range(log2m):
            blocks = m >> (s + 1) if gs else 1 << s
            width = m // (2 * blocks)
            tw = tuple(r[pl.ds(blocks, blocks)].reshape(1, blocks, 1, 1)
                       for r in refs)
            lo, hi = jnp.split(x.reshape(rows, blocks, 2, width), 2, axis=2)
            if gs:
                lo, hi = ar.add(lo, hi), ar.mul_const(ar.sub(lo, hi), tw)
            else:
                t = ar.mul_const(hi, tw)
                lo, hi = ar.add(lo, t), ar.sub(lo, t)
            x = _interleave(lo, hi, axis=2).reshape(rows, m)
        return x

    def _forward(self, x, refs):
        """(rows, n) tile -> list of 2^levels (rows, m) spectra."""
        return [self._stages(s, refs, gs=False)
                for s in _deinterleave(x, 1 << self.levels)]

    def _inverse(self, subs, refs):
        """list of (rows, m) spectra -> (rows, n) tile."""
        out = [self.arith.mul_const(self._stages(s, refs, gs=True),
                                    self._scale) for s in subs]
        if len(out) == 1:
            return out[0]
        rows, m = out[0].shape
        return _interleave(*(o.reshape(rows, m, 1) for o in out),
                           axis=2).reshape(rows, m * len(out))

    def _pointwise(self, fa, fb, t=None):
        """Spectral product (the plan's pointwise / base-case product)."""
        ar = self.arith
        if self.levels == 0:
            return [ar.mul(fa[0], fb[0])]
        # IncompletePlan._basemul for levels=1, t = the twist table
        c0 = ar.add(ar.mul(fa[0], fb[0]),
                    ar.mul_const(ar.mul(fa[1], fb[1]), t))
        c1 = ar.add(ar.mul(fa[0], fb[1]), ar.mul(fa[1], fb[0]))
        return [c0, c1]

    # ------------------------------------------------------------------
    # pallas_calls over (B, ...) arrays, B a multiple of ROWS
    # ------------------------------------------------------------------

    def _call(self, body, ins, n_in_tiles, out_widths):
        """One pallas_call: the first ``n_in_tiles`` inputs are (B, w)
        tiled by rows, the rest are whole 1-D tables."""
        B = ins[0].shape[0]
        row_spec = lambda w: pl.BlockSpec((ROWS, w), lambda i: (i, 0))
        in_specs = [row_spec(x.shape[1]) for x in ins[:n_in_tiles]]
        in_specs += [pl.BlockSpec(x.shape, lambda i: (0,))
                     for x in ins[n_in_tiles:]]
        outs = [jax.ShapeDtypeStruct((B, w), jnp.int32) for w in out_widths]
        return pl.pallas_call(
            body, out_shape=outs, grid=(B // ROWS,), in_specs=in_specs,
            out_specs=[row_spec(w) for w in out_widths],
            compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS),
            interpret=self.interpret, name="fused_ntt")(*ins)

    def _tables(self, *names):
        return [jnp.asarray(c) for nm in names for c in getattr(self, nm)]

    def _polymul_call(self, a, b):
        nf, ni = len(self._fwd), len(self._inv)

        def body(a_ref, b_ref, *refs):
            f, i = refs[:nf], refs[nf:nf + ni]
            t = tuple(r[...].reshape(1, self.m) for r in
                      refs[nf + ni:-1]) or None
            fa = self._forward(a_ref[...], f)
            fb = self._forward(b_ref[...], f)
            refs[-1][...] = self._inverse(self._pointwise(fa, fb, t), i)

        tabs = self._tables("_fwd", "_inv", "_twist")
        return self._call(body, [a, b, *tabs], 2, [self.n])[0]

    def _forward_call(self, x):
        nf = len(self._fwd)

        def body(x_ref, *refs):
            for o, s in zip(refs[nf:], self._forward(x_ref[...],
                                                     refs[:nf])):
                o[...] = s

        return self._call(body, [x, *self._tables("_fwd")], 1,
                          [self.m] * (1 << self.levels))

    def _inverse_call(self, subs):
        k = len(subs)

        def body(*refs):
            subs_in = [r[...] for r in refs[:k]]
            refs[-1][...] = self._inverse(subs_in, refs[k:-1])

        return self._call(body, [*subs, *self._tables("_inv")], k,
                          [self.n])[0]

    # ------------------------------------------------------------------
    # public: the plan's signatures on (..., n) int32 arrays
    # ------------------------------------------------------------------

    def forward(self, x):
        """Spectrum of ``x``: an array for the full transform, a list of
        2^levels arrays for the incomplete one (as the plan returns)."""
        x = jnp.asarray(x, jnp.int32)
        flat, unpad = _rows(x)
        subs = [unpad(s) for s in self._forward_call(flat)]
        return subs[0] if self.levels == 0 else subs

    def inverse(self, spec):
        subs = [spec] if self.levels == 0 else list(spec)
        flat = [_rows(jnp.asarray(s, jnp.int32))[0] for s in subs]
        return _rows(subs[0])[1](self._inverse_call(flat))

    def pointwise(self, fa, fb):
        """The plan's spectral product of two :meth:`forward` outputs
        (XLA; used between the kernels)."""
        return self.plan.pointwise(fa, fb)

    def polymul(self, a, b):
        """Products of (..., n) operands; host operands are checked
        against [0, q) when validation is on (tpu_ntt.validation)."""
        from ..validation import check_domain
        check_domain(a, self.q, "fused polymul a")
        check_domain(b, self.q, "fused polymul b")
        a = jnp.asarray(a, jnp.int32)
        b = jnp.asarray(b, jnp.int32)
        a, b = jnp.broadcast_arrays(a, b)
        fa, unpad = _rows(a)
        return unpad(self._polymul_call(fa, _rows(b)[0]))

    def matvec(self, A, s):
        """Module product A (..., r, c, n) x s (..., c, n) -> (..., r, n):
        the kernel's forward transforms, an XLA multiply-accumulate over
        the spectra, and the kernel's inverse transforms."""
        A = jnp.asarray(A, jnp.int32)
        s = jnp.asarray(s, jnp.int32)
        r, c = A.shape[-3], A.shape[-2]
        if s.shape[-2] != c:
            raise ValueError(f"matvec shape mismatch: A cols {c} vs "
                             f"s entries {s.shape[-2]}")
        full = self.levels == 0
        fA = self.forward(A)                      # (..., r, c, m)
        fs = self.forward(s)                      # (..., c, m)
        fA, fs = ([fA], [fs]) if full else (fA, fs)
        acc = None
        for j in range(c):
            a_j = [x[..., j, :] for x in fA]
            s_j = [x[..., None, j, :] for x in fs]
            t = ([self.pointwise(a_j[0], s_j[0])] if full
                 else self.pointwise(a_j, s_j))
            acc = t if acc is None else [self.arith.add(x, y)
                                         for x, y in zip(acc, t)]
        return self.inverse(acc[0] if full else acc)

    @functools.cached_property
    def polymul_jit(self):
        return jax.jit(self.polymul)

    @functools.cached_property
    def matvec_jit(self):
        return jax.jit(self.matvec)


def _deinterleave(x, k):
    """(rows, n) -> k strided (rows, n/k) sub-polynomials: sub j holds
    coefficients j, j+k, j+2k, ... (IncompletePlan._split)."""
    if k == 1:
        return [x]
    rows, n = x.shape
    parts = jnp.split(x.reshape(rows, n // k, k), k, axis=2)
    return [p.reshape(rows, n // k) for p in parts]


def _interleave(lo, hi, axis):
    """Inverse of ``split(v, 2, axis)`` for arrays with a unit ``axis``:
    joins along a new last axis, then moves it to ``axis`` (Triton joins
    only along the last axis)."""
    shape = lo.shape[:axis] + lo.shape[axis + 1:] + (1,)
    y = jnp.concatenate([lo.reshape(shape), hi.reshape(shape)], axis=-1)
    perm = list(range(y.ndim - 1))
    perm.insert(axis, y.ndim - 1)
    return jnp.transpose(y, perm)


def _rows(x):
    """(..., w) -> ((B, w) padded to a multiple of ROWS, undo)."""
    lead, w = x.shape[:-1], x.shape[-1]
    flat = x.reshape(-1, w)
    B = flat.shape[0]
    pad = (-B) % ROWS
    if pad:
        flat = jnp.pad(flat, ((0, pad), (0, 0)))

    def unpad(y):
        return y[:B].reshape(*lead, y.shape[-1])

    return flat, unpad

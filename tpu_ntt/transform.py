"""Plan/execute API: batched NTT, INTT and polynomial products in pure XLA.

This is the library's equivalent of the reference accelerator's command
protocol (``PolyMult.v:110-124`` modes 0..3 driven by
``NTT_PCIECommunicationv2.c:109-224``):

===========================  =============================================
reference                    here
===========================  =============================================
mode 0 (load twiddles+q)     ``Plan(params)`` — precomputes every stage
                             twiddle + arithmetic companion table
mode 1/2 (load A / B)        function arguments (jax device arrays)
mode 3 ("GO")                ``plan.polymul(a, b)`` — one jitted XLA call
busy/done polling            none: dispatch is synchronous XLA
===========================  =============================================

Transform algebra (the reference's own optimized pairing, generalised):

- forward: Cooley–Tukey std2rev with the psi twist *merged into the stage
  twiddles* — the ``mulntt_red_ct_std2rev`` variant (ntt_red.c:368-397)
  whose product pipeline the reference declares but never implements
  (ntt_red256.h:88-91, products 2/3/5); we complete that design.
- pointwise product in the bit-reversed domain (order-agnostic).
- inverse: Gentleman–Sande rev2std with the psi^-1 twist merged
  (``nttmul_red_gs_rev2std``, ntt_red.c:456-479) plus a final n^-1 scale.
- no bit-reversal permutation is ever materialised
  (the std2rev/rev2std pairing trick of ntt_red256.C:8,23).

All eight plain CT/GS × std2rev/rev2std variants of ntt.C are also exposed
through :meth:`Plan.ntt` for API/semantics parity with the C library.

Every stage is one vectorised butterfly over a ``(..., blocks, 2, width)``
view — reshapes XLA lowers to relayouts, arithmetic in int32 lanes (see
ops/modmul.py).  The fused GPU kernel (ops/fused.py) serves the small rings
on a GPU; this module is the portable XLA path it is tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ops.modmul import Arith, select_arith
from .params import NTTParams, stage_powers
from .utils.bitrev import bit_reverse_indices

__all__ = ["Plan", "polymul", "ntt", "intt"]


# stage geometry: (kind, order) -> per-stage (t, blocks, width, tw_axis)
# where t is the twiddle count (flat-table slice [t, 2t)), the data is viewed
# as (..., blocks, 2, width), and tw_axis says whether twiddles broadcast per
# block (-3) or per within-block position (-1).  Derived from the C loop
# nests (ntt_red.c:244-554); see ref.py for the same mapping in NumPy.
def _stage_geometry(kind: str, order: str, log2n: int):
    n = 1 << log2n
    out = []
    for i in range(log2n):
        if kind == "ct":
            t = 1 << i
            if order == "std2rev":
                out.append((t, t, n // (2 * t), -3))
            else:
                out.append((t, n // (2 * t), t, -1))
        else:
            if order == "std2rev":
                t = n >> (i + 1)
                out.append((t, n // (2 * t), t, -1))
            else:
                d = 1 << i
                t = n // (2 * d)
                out.append((t, t, d, -3))
    return out


def _table_key(kind: str, order: str) -> bool:
    """True if the variant consumes bit-reversed-order stage tables
    (ntt_red256.h:21-52 wiring)."""
    return (kind, order) in (("ct", "std2rev"), ("gs", "rev2std"))


class Plan:
    """Precomputed transform plan for one (params, batch-agnostic) config.

    Holds host-side twiddle/companion tables; methods return cached jitted
    callables closing over them.  The mode-0 analog: building a Plan is the
    only place twiddles are generated/loaded.
    """

    def __init__(self, params: NTTParams, arith: Arith | None = None):
        self.params = params
        self.arith = arith if arith is not None else select_arith(params.q)
        self._scale = self.arith.pointwise_fix  # cancels stray R^-1 of mul()

    # ------------------------------------------------------------------
    # twiddle preparation (host-side, cached)
    # ------------------------------------------------------------------

    @functools.lru_cache(maxsize=None)
    def _stage_tables(self, kind: str, order: str, inverse: bool,
                      mixed: bool):
        p = self.params
        base = p.omega_inv if inverse else p.omega
        psi_b = 0
        if mixed:
            psi_b = p.psi_inv if inverse else p.psi
        flat = stage_powers(p, base, rev=_table_key(kind, order),
                            psi_base=psi_b)
        tabs = []
        for t, blocks, width, axis in _stage_geometry(kind, order, p.log2n):
            ct = self.arith.const_table(flat[t:2 * t])
            # broadcast shape: (t,1) over blocks or (1,t) over width
            # keep tables as numpy: converting to jnp inside a jit trace
            # would capture (and leak) tracers into the lru_cache
            shaped = tuple(
                np.asarray(c).reshape((t, 1) if axis == -3 else (1, t))
                for c in ct)
            tabs.append((blocks, width, shaped))
        return tabs

    @functools.lru_cache(maxsize=None)
    def _scalar_table(self, c: int):
        return self.arith.const_table(np.array([c]))

    # ------------------------------------------------------------------
    # core stage application
    # ------------------------------------------------------------------

    def _apply_stages(self, x, kind: str, order: str, inverse: bool,
                      mixed: bool):
        ar = self.arith
        n = self.params.n
        lead = x.shape[:-1]
        for blocks, width, shaped in self._stage_tables(
                kind, order, inverse, mixed):
            v = x.reshape(lead + (blocks, 2, width))
            lo = v[..., 0, :]
            hi = v[..., 1, :]
            if kind == "ct":
                m = ar.mul_const(hi, shaped)
                lo, hi = ar.add(lo, m), ar.sub(lo, m)
            else:
                lo, hi = ar.add(lo, hi), ar.mul_const(ar.sub(lo, hi), shaped)
            x = jnp.stack([lo, hi], axis=-2).reshape(lead + (n,))
        return x

    # ------------------------------------------------------------------
    # public transforms (each returns a cached jitted callable when used
    # through the module-level wrappers; direct calls are trace-friendly)
    # ------------------------------------------------------------------

    def ntt(self, x, kind: str = "ct", order: str = "std2rev",
            inverse: bool = False, mixed: bool = False):
        """Generic batched NTT over the last axis — any of the eight
        variants of ntt.C (plus psi-merged 'mixed' forms)."""
        return self._apply_stages(jnp.asarray(x, jnp.int32), kind, order,
                                  inverse, mixed)

    def forward(self, x):
        """Flagship forward: psi-merged CT std2rev (negacyclic) or plain
        CT std2rev (cyclic). Natural order in, bit-reversed out."""
        return self.ntt(x, "ct", "std2rev", mixed=self.params.negacyclic)

    def inverse(self, x):
        """Flagship inverse: psi^-1-merged GS rev2std + n^-1 scale.
        Bit-reversed in, natural order out, canonical [0,q)."""
        p = self.params
        y = self.ntt(x, "gs", "rev2std", inverse=True,
                     mixed=p.negacyclic)
        return self.arith.mul_const(
            y, self._scalar_table(p.n_inv * self._scale % p.q))

    def pointwise(self, fa, fb):
        """Coefficient-wise product (PolyPointwiseMult.v analog); output
        carries arith.pointwise_fix^-1, cancelled by inverse()'s scale."""
        return self.arith.mul(fa, fb)

    def polymul(self, a, b):
        """Full product in Z_q[x]/(x^n+1) (negacyclic, psi set) or
        /(x^n-1) (cyclic) — the mode-3 "GO" pipeline as one XLA graph."""
        fa = self.forward(a)
        fb = self.forward(b)
        return self.inverse(self.pointwise(fa, fb))

    def matvec(self, A, s):
        """Module (matrix-of-rings) product: A (..., r, c, n) x
        s (..., c, n) -> (..., r, n), each entry a ring product.

        The lattice-crypto usage pattern (ML-KEM A_hat*s_hat, ML-DSA):
        transform the c vector entries once, accumulate the r·c spectral
        products with modular adds, and run only r inverse transforms —
        instead of r·c full polymuls.  Spectral pointwise is linear, so
        the accumulated sum shares one inverse()/scale."""
        A = jnp.asarray(A, jnp.int32)
        s = jnp.asarray(s, jnp.int32)
        r, c = A.shape[-3], A.shape[-2]
        if s.shape[-2] != c:
            raise ValueError(f"matvec shape mismatch: A cols {c} vs "
                             f"s entries {s.shape[-2]}")
        fs = [self.forward(s[..., j, :]) for j in range(c)]
        rows = []
        for i in range(r):
            acc = None
            for j in range(c):
                t = self.pointwise(self.forward(A[..., i, j, :]), fs[j])
                acc = t if acc is None else self.arith.add(acc, t)
            rows.append(self.inverse(acc))
        return jnp.stack(rows, axis=-2)

    @functools.cached_property
    def matvec_jit(self):
        return jax.jit(self.matvec)

    # -- hardware-flow parity (PolyMult GO with explicit bit-reversal) --

    def hw_polymul(self, a, b):
        """Bit-exact twin of the FPGA GO flow (PolyMult.v:176-267):
        cyclic product via plain GS std2rev NTTs, pointwise, explicit
        bit-reverse, GS std2rev INTT, final un-reverse."""
        p = self.params
        rev = jnp.asarray(bit_reverse_indices(p.n))
        fa = self.ntt(a, "gs", "std2rev")
        fb = self.ntt(b, "gs", "std2rev")
        c = self.pointwise(fa, fb)
        c = self.arith.mul_const(
            c, self._scalar_table(self._scale % p.q))  # cancel R^-1
        c = jnp.take(c, rev, axis=-1)
        c = self.ntt(c, "gs", "std2rev", inverse=True)
        c = self.arith.mul_const(c, self._scalar_table(p.n_inv))
        return jnp.take(c, rev, axis=-1)

    # ------------------------------------------------------------------
    # cached jitted entry points
    # ------------------------------------------------------------------

    @functools.cached_property
    def polymul_jit(self):
        return jax.jit(self.polymul)

    @functools.cached_property
    def forward_jit(self):
        return jax.jit(self.forward)

    @functools.cached_property
    def inverse_jit(self):
        return jax.jit(self.inverse)

    def __hash__(self):
        return hash((self.params, type(self.arith).__name__))

    def __eq__(self, other):
        return (isinstance(other, Plan) and self.params == other.params
                and type(self.arith) is type(other.arith))


# ---------------------------------------------------------------------------
# convenience wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _plan_cache(params: NTTParams) -> Plan:
    return Plan(params)


def polymul(a, b, params: NTTParams):
    """One-shot polynomial product (plan cached per params)."""
    return _plan_cache(params).polymul_jit(a, b)


def ntt(x, params: NTTParams):
    return _plan_cache(params).forward_jit(x)


def intt(x, params: NTTParams):
    return _plan_cache(params).inverse_jit(x)

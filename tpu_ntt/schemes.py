"""Incomplete (truncated) NTT and PQC-scheme parameter points.

The BASELINE "Kyber-style" config (n=256, q=3329) has no 512-th root of
unity — q-1 = 2^8·13 — so the full negacyclic transform does not exist.
The standard solution (as in ML-KEM itself) is the *incomplete* NTT: stop
``levels`` short of a full decimation, transforming the ring

    Z_q[x]/(x^n + 1)  ≅  Π_k  Z_q[y]/(y^{2^L} − t_k)

by splitting a(x) into 2^L strided sub-polynomials a_j(y), y = x^{2^L},
each living in the *size-m negacyclic* ring (m = n/2^L, which q does
support), and multiplying pointwise with a 2^L-coefficient "base case"
twisted by t_k — the evaluation point of y at spectral slot k.

Everything reuses the existing machinery: the m-point sub-transforms are
ordinary :class:`~tpu_ntt.transform.Plan` forwards/inverses (psi-merged CT
std2rev / GS rev2std), so t_k = psi_m^(2·bitrev(k)+1) in the forward's
own output order and no permutation is ever materialised.

This is capability *beyond* the reference (which only supports full
transforms at q ≡ 1 mod 2n); cited here against the parameter menu it
generalises (test_generator.py:52-81).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .params import make_params
from .transform import Plan
from .utils.bitrev import bit_reverse_indices

__all__ = ["IncompletePlan", "kyber_plan", "auto_plan"]


def _max_two_power(x: int) -> int:
    return x & -x


class IncompletePlan:
    """Negacyclic polymul in Z_q[x]/(x^n+1) via an incomplete NTT.

    levels L is chosen (or given) so the size-m sub-ring (m = n >> L) has
    a primitive 2m-th root mod q.  L=0 degenerates to a full Plan.
    """

    def __init__(self, n: int, q: int, levels: int | None = None):
        from .params import is_prime
        if not is_prime(q):
            raise ValueError(f"q={q} is not prime")
        two_pow = _max_two_power(q - 1)
        if levels is None:
            levels = max(0, (2 * n // two_pow).bit_length() - 1)
        self.levels = levels
        self.n, self.q = n, q
        m = n >> levels
        if m < 2 or 2 * m > two_pow:
            raise ValueError(
                f"q={q} cannot support an incomplete NTT of n={n} with "
                f"{levels} levels (sub-size {m} needs 2m | q-1)")
        self.m = m
        self.sub = Plan(make_params(m, q))          # negacyclic size-m plan
        self.arith = self.sub.arith
        self._tables()

    def _tables(self):
        p = self.sub.params
        q = self.q
        rev = bit_reverse_indices(self.m)
        # t[k] = psi_m^(2*bitrev(k)+1): the value of y at spectral slot k
        exps = (2 * rev + 1) % (2 * self.m)
        t = np.array([pow(p.psi, int(e), q) for e in exps], dtype=np.int64)
        # every base-case term contains exactly one data-data mul (carrying
        # fix^-1, cancelled by the sub-plan's inverse scale); the t twist is
        # a constant multiply (exact), so the plain table is the right one
        self._t = self.arith.const_table(t)

    # ------------------------------------------------------------------

    def _split(self, a):
        """(…, n) -> tuple of 2^L arrays (…, m): strided sub-polynomials."""
        L = self.levels
        v = a.reshape(*a.shape[:-1], self.m, 1 << L)
        return [v[..., j] for j in range(1 << L)]

    def _merge(self, subs):
        v = jnp.stack(subs, axis=-1)
        return v.reshape(*v.shape[:-2], self.n)

    def _basemul(self, fa, fb):
        """Pointwise product of degree-(2^L−1) residues mod (y^{2^L} − t_k).

        L=1:  c0 = a0·b0 + t·a1·b1 ;  c1 = a0·b1 + a1·b0
        general L: schoolbook with wrap-around terms multiplied by t.
        """
        ar = self.arith
        two_l = 1 << self.levels
        c = [None] * two_l
        for j in range(two_l):
            acc = None
            for i in range(j + 1):
                term = ar.mul(fa[i], fb[j - i])
                acc = term if acc is None else ar.add(acc, term)
            wrap = None
            for i in range(j + 1, two_l):
                term = ar.mul(fa[i], fb[two_l + j - i])
                wrap = term if wrap is None else ar.add(wrap, term)
            if wrap is not None:
                wrap = ar.mul_const(wrap, self._t)
                acc = ar.add(acc, wrap) if acc is not None else wrap
            c[j] = acc
        return c

    # ------------------------------------------------------------------

    def forward(self, x):
        """Split + per-sub-polynomial merged forward NTTs."""
        return [self.sub.forward(s) for s in self._split(
            jnp.asarray(x, jnp.int32))]

    def inverse(self, subs):
        return self._merge([self.sub.inverse(s) for s in subs])

    def pointwise(self, fa, fb):
        """Spectral product of two forward() outputs (the degree-(2^L-1)
        base-case multiplication); scale-compatible with inverse(), like
        Plan.pointwise (carries arith.pointwise_fix^-1 when != 1)."""
        return self._basemul(fa, fb)

    def polymul(self, a, b):
        """Negacyclic product: split, sub-transforms, base-case product,
        inverse."""
        fa = self.forward(a)
        fb = self.forward(b)
        return self.inverse(self._basemul(fa, fb))

    @functools.cached_property
    def polymul_jit(self):
        return jax.jit(self.polymul)

    def matvec(self, A, s):
        """Module product A (..., r, c, n) x s (..., c, n) -> (..., r, n)
        — the ML-KEM A_hat*s_hat pattern: one forward per vector entry,
        spectral basemul-accumulate, one inverse per output row (the
        base-case product is linear, so sums share one inverse)."""
        A = jnp.asarray(A, jnp.int32)
        s = jnp.asarray(s, jnp.int32)
        r, c = A.shape[-3], A.shape[-2]
        if s.shape[-2] != c:
            raise ValueError(f"matvec shape mismatch: A cols {c} vs "
                             f"s entries {s.shape[-2]}")
        ar = self.arith
        fs = [self.forward(s[..., j, :]) for j in range(c)]
        rows = []
        for i in range(r):
            acc = None
            for j in range(c):
                t = self._basemul(self.forward(A[..., i, j, :]), fs[j])
                acc = t if acc is None else [ar.add(x, y)
                                             for x, y in zip(acc, t)]
            rows.append(self.inverse(acc))
        return jnp.stack(rows, axis=-2)

    @functools.cached_property
    def matvec_jit(self):
        return jax.jit(self.matvec)


def kyber_plan(backend: str = "auto"):
    """ML-KEM ring: n=256, q=3329, one missing level (128 quadratic
    residues) — the real Kyber parameter point.  The plan the engine
    builds (:func:`~tpu_ntt.dispatch.build_plan`): an
    :class:`IncompletePlan`, wrapped in the fused kernel on a GPU."""
    from .dispatch import build_plan
    return build_plan(256, 3329, backend=backend)[1]


def auto_plan(n: int, q: int, backend: str = "auto"):
    """The plan the engine builds for Z_q[x]/(x^n+1)
    (:func:`~tpu_ntt.dispatch.build_plan`): a full Plan when
    q ≡ 1 (mod 2n), else an IncompletePlan; the fused kernel wraps either
    on a GPU where it covers the ring."""
    from .dispatch import build_plan
    return build_plan(n, q, backend=backend)[1]

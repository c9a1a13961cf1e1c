"""Vectorized modular multiply-reduce strategies for int32 vector lanes.

Vectorised replacement for the reference's modular arithmetic stack:

- ``intMult.v`` (K×K→2K multiplier built from 16-bit DSP chunks) and
  ``ModRed.v``/``ModRed_sub.v`` (Mert et al. word-level Montgomery-style
  reduction with tables pre-scaled by R = 2^(W_SIZE·L_SIZE)),
- ``ntt_red.c:34-46`` (``red``/``mul_red`` Longa–Naehrig reduction),
- ``ntt.C:69-106`` (``add_mod``/``sub_mod``/``modq``).

The lanes are int32 with wrap-around semantics and no 64-bit multiply,
so every strategy here is built from int32 products that provably stay
below 2^31:

:class:`ShoupArith` (q < 2^15)
    Harvey/Shoup multiplication: per-constant precomputed
    ``w' = floor(w·2^16/q)`` gives ``x·w mod q`` in 3 multiplies.  Data×data
    products reduce via one fold plus a Shoup multiply by ``2^15 mod q``.
    Covers the reference's parameter points q=7681, q=12289 and Kyber 3329.

:class:`MontArith` (q < 2^29)
    Digit-serial Montgomery with base β=2^15, R=2^30: the same scheme the
    FPGA's word-level reducer implements in silicon (ModRed_sub.v chains,
    W.txt twiddles stored R-scaled), re-derived for 15-bit limb products in
    int32 lanes.  Constants are stored in Montgomery form (·R mod q) so a
    single REDC per multiply returns plain-domain results — mirroring how
    the hardware pre-scales its twiddle stream (test_generator.py:183-189).

All member functions take/return jnp int32 arrays with canonical values in
[0, q); bounds are asserted in the test-suite, not at runtime.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

__all__ = ["Arith", "ShoupArith", "MontArith", "select_arith"]

_M15 = (1 << 15) - 1


def _csub(x, q):
    """Conditional subtract: [0, 2q) -> [0, q), branchless (ntt.C:76-80)."""
    r = x - q
    return r + ((r >> 31) & q)


@dataclasses.dataclass(frozen=True)
class Arith:
    """Base: canonical add/sub shared by all strategies."""

    q: int

    def add(self, x, y):
        return _csub(x + y, jnp.int32(self.q))

    def sub(self, x, y):
        r = x - y
        return r + ((r >> 31) & jnp.int32(self.q))

    def correct(self, x):
        """[0, 2q) -> [0, q)."""
        return _csub(x, jnp.int32(self.q))

    # -- interface --
    def const_table(self, w: np.ndarray) -> tuple[np.ndarray, ...]:
        """Host-side companion tables for constant multiplicands ``w``."""
        raise NotImplementedError

    def mul_const(self, x, tab):
        """Elementwise ``x * w mod q`` with ``tab = const_table(w)``."""
        raise NotImplementedError

    def mul(self, x, y):
        """Elementwise data×data ``x * y mod q``."""
        raise NotImplementedError

    @property
    def pointwise_fix(self) -> int:
        """Scale factor (mod q) introduced by one ``mul`` that downstream
        constants must cancel (R for Montgomery, 1 for Shoup)."""
        return 1


@dataclasses.dataclass(frozen=True)
class ShoupArith(Arith):
    """Shoup/Harvey multiplication for q < 2^15; values canonical [0, q).

    For constant w with companion w' = floor(w·2^16/q):
        t = (x·w') >> 16;  r = x·w − t·q  ∈ [0, 2q)
    All products < 2^31 for x < 2^15 (proof: x·w' ≤ (2^15−1)(2^16−1)).
    """

    def __post_init__(self):
        if self.q >= 1 << 15:
            raise ValueError("ShoupArith requires q < 2^15")

    def const_table(self, w: np.ndarray):
        w = np.asarray(w, dtype=np.int64) % self.q
        w_sh = (w << 16) // self.q
        return (w.astype(np.int32), w_sh.astype(np.int32))

    def mul_const(self, x, tab, lazy: bool = False):
        w, w_sh = tab
        t = (x * w_sh) >> 16
        r = x * w - t * jnp.int32(self.q)
        return r if lazy else _csub(r, jnp.int32(self.q))

    def mul(self, x, y):
        # z = x·y < 2^30; split z = hi·2^15 + lo with hi, lo < 2^15, then
        # reduce each half with a Shoup multiply (by 2^15 mod q and by 1 —
        # Shoup by 1 is a pure range reduction, valid for any x < 2^15).
        # Deterministic bounds: each half lands in [0, 2q) -> csub -> [0, q),
        # final add_mod.  (A single fold + 2 csubs is NOT enough: lo can be
        # up to 2^15 - 1 ≈ 10q for Kyber's q=3329.)
        q = jnp.int32(self.q)
        z = x * y
        hi = z >> 15
        lo = z & jnp.int32(_M15)
        c = (1 << 15) % self.q
        r1 = self.mul_const(hi, (jnp.int32(c), jnp.int32((c << 16) // self.q)))
        r2 = self.mul_const(lo, (jnp.int32(1), jnp.int32((1 << 16) // self.q)))
        return self.add(r1, r2)


@dataclasses.dataclass(frozen=True)
class MontArith(Arith):
    """15-bit digit-serial Montgomery (β=2^15, R=2^30) for q < 2^29.

    The int32-lane twin of the FPGA's word-level reduction pipeline
    (ModRed.v generate-chain): two REDC digits instead of L_SIZE ModRed_sub
    stages.  Constants live in Montgomery form w·R mod q, so
    ``mont_mul(x, w·R) = x·w mod q`` — plain in, plain out, exactly like
    the hardware's R-scaled twiddle stream.
    """

    def __post_init__(self):
        if self.q >= 1 << 29:
            raise ValueError("MontArith requires q < 2^29")
        if self.q % 2 == 0:
            raise ValueError("q must be odd")

    @property
    def R(self) -> int:
        return 1 << 30

    @property
    def qprime(self) -> int:
        """-q^-1 mod 2^15."""
        return (-pow(self.q, -1, 1 << 15)) % (1 << 15)

    def const_table(self, w: np.ndarray):
        w = np.asarray(w, dtype=object) % self.q
        wR = (w * self.R) % self.q
        return (np.array(wR.tolist(), dtype=np.int64).astype(np.int32),)

    def _redc(self, H, Mid, L0):
        """REDC of z = H·2^30 + Mid·2^15 + L0 (H<2^28, Mid<2^30, L0<2^30):
        returns z·R^-1 mod q in [0, q).  All intermediates < 2^31."""
        q = jnp.int32(self.q)
        q1 = jnp.int32(self.q >> 15)
        q0 = jnp.int32(self.q & _M15)
        qp = jnp.int32(self.qprime)
        m = jnp.int32(_M15)

        u0 = ((L0 & m) * qp) & m
        t1 = (L0 + u0 * q0) >> 15            # exact: low 15 bits cancel
        A1 = Mid + u0 * q1 + t1              # < 2^30 + 2^29 + 2^16
        a1h = A1 >> 15
        a1l = A1 & m
        u1 = (a1l * qp) & m
        t2 = (a1l + u1 * q0) >> 15
        res = H + a1h + u1 * q1 + t2         # < 1.5q + eps
        return _csub(_csub(res, q), q)

    def _mul_full(self, x, y):
        m = jnp.int32(_M15)
        x1, x0 = x >> 15, x & m
        y1, y0 = y >> 15, y & m
        return self._redc(x1 * y1, x1 * y0 + x0 * y1, x0 * y0)

    def mul_const(self, x, tab):
        (wR,) = tab
        return self._mul_full(x, wR)         # x·wR·R^-1 = x·w

    def mul(self, x, y):
        """Plain x·y·R^-1 mod q — callers fold the stray R^-1 into a
        downstream constant (see Arith.pointwise_fix)."""
        return self._mul_full(x, y)

    @property
    def pointwise_fix(self) -> int:
        return self.R % self.q


@dataclasses.dataclass(frozen=True)
class FBarrettArith(Arith):
    """Float-assisted Barrett multiplication for q < 2^23 (exact).

    The quotient estimate runs on f32 lanes, the residual on int32
    wraparound lanes:

        t  = trunc(f32(x) · f32(w/q))          # |t − ⌊x·w/q⌋| ≤ 3
        r  = x·w − t·q + 3q   (mod 2^32)       # exact: r ∈ [0, 7q) < 2^26
        two conditional subtracts → [0, 2q) lazy / one more → canonical

    Exactness argument: for x < 2^24 the f32 conversion is exact and the
    two roundings (w/q table entry, product) bound the estimate error by
    x·w/q · 2^-23 ≤ 2.001, so t is within ±3 of the true quotient; the
    residual x·w − t·q then lies in (−3q, 4q) ⊂ (−2^31, 2^31) and int32
    wraparound arithmetic recovers it exactly even though the raw products
    are ~2^46.  This replaces the reference's word-level reduction chain
    (ModRed_sub.v:35-60) with the float unit: the f32 path
    computes the quotient the FPGA derives digit-serially.

    Costs 3 multiplies + 2 lane conversions per constant multiply — half
    the digit-serial Montgomery chain — and covers Dilithium's q=8380417
    (= 2^23 − 2^13 + 1, the largest standard lattice modulus).  Values
    canonical [0, q) at the API boundary, like ShoupArith.
    """

    def __post_init__(self):
        if self.q >= 1 << 23:
            raise ValueError("FBarrettArith requires q < 2^23")

    def const_table(self, w: np.ndarray):
        w = np.asarray(w, dtype=np.int64) % self.q
        # f64 host quotient, one f32 rounding: |δ| ≤ 2^-24 relative
        wq = (w.astype(np.float64) / float(self.q)).astype(np.float32)
        return (w.astype(np.int32), wq)

    def _raw(self, x, w, wq):
        """x·w − t·q + 3q ∈ [0, 7q), exact for x < 2^24."""
        q = jnp.int32(self.q)
        t = (x.astype(jnp.float32) * wq).astype(jnp.int32)
        return x * w - t * q + jnp.int32(3 * self.q)

    def mul_const(self, x, tab, lazy: bool = False):
        w, wq = tab
        r = _csub(self._raw(x, w, wq), jnp.int32(4 * self.q))
        r = _csub(r, jnp.int32(2 * self.q))
        return r if lazy else _csub(r, jnp.int32(self.q))

    def mul(self, x, y):
        # data×data: both operands canonical < q < 2^23 → f32-exact;
        # three roundings (two products + the 1/q constant) keep the
        # estimate within ±3 of the true quotient
        q = jnp.int32(self.q)
        pf = (x.astype(jnp.float32) * y.astype(jnp.float32)
              * jnp.float32(1.0 / self.q))
        t = pf.astype(jnp.int32)
        r = x * y - t * q + jnp.int32(3 * self.q)
        r = _csub(r, jnp.int32(4 * self.q))
        return _csub(_csub(r, jnp.int32(2 * self.q)), q)


def select_arith(q: int) -> Arith:
    """Pick the fastest exact strategy for modulus q (int32 lanes)."""
    if q < (1 << 15):
        return ShoupArith(q)
    if q < (1 << 23):
        return FBarrettArith(q)
    if q < (1 << 29):
        return MontArith(q)
    raise NotImplementedError(
        f"q={q} needs the multi-limb/RNS path (q >= 2^29)")

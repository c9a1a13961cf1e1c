"""Matmul backend (``backend="matmul"``): the NTT as exact bf16-limb
matrix multiplication.

The whole transform is expressed as dense matrix products, so a matrix
unit does the butterfly arithmetic that transform.py does elementwise:

    spectrum = X @ F        F[i, pos] = psi^i · omega^(i·bitrev(pos))

O(n²) multiply-adds instead of O(n log n) elementwise ops — worth it only
while n is small enough that the matrix unit's higher rate covers the
n/log n factor.  Whether it is on a given device is a measurement; the
platform rule never picks this backend on its own.

Exactness: operands are split into 7-bit limbs stored as bf16 (integers
≤ 127 are exact in bf16); each partial product is ≤ 127², and a row of n
of them sums below 2^24 for n ≤ 1024 — exactly representable in the f32
accumulator, so the matmul result is an exact integer (bf16 operands
never take a TF32 path).  The four limb-pair partials are then reduced and
recombined mod q in int32 (Shoup constant multiplies).

This is the same narrow-multiplier decomposition the reference's
``intMult.v:46-71`` performs with 16-bit DSP chunks — re-targeted at a
matrix unit's bf16 operand width.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..params import NTTParams, modinv
from ..utils.bitrev import bit_reverse_indices
from .modmul import ShoupArith

__all__ = ["MatmulNTT", "supported"]

_LIMB = 7
_LMASK = (1 << _LIMB) - 1


def supported(params: NTTParams) -> bool:
    """Two 7-bit limbs cover q < 2^14; f32 accumulation is exact while
    n·127² < 2^24, i.e. n ≤ 1024.  Cyclic (psi=0) works too — the
    merged-twist column degenerates to all-ones."""
    return params.q < (1 << 14) and params.n <= 1024


class MatmulNTT:
    """Plan-compatible polymul computed as limb matrix products."""

    def __init__(self, params: NTTParams):
        if not supported(params):
            raise ValueError(
                f"MatmulNTT needs q < 2^14, n <= 1024 "
                f"(got n={params.n}, q={params.q})")
        self.params = params
        self.arith = ShoupArith(params.q)
        self._build_matrices()

    def _build_matrices(self):
        p = self.params
        n, q = p.n, p.q
        rev = bit_reverse_indices(n)
        i = np.arange(n, dtype=np.int64)
        # forward: F[i, pos] = psi^i · omega^(i·bitrev(pos))  (merged twist,
        # bitrev output order — identical semantics to Plan.forward)
        def powmat(base_psi, base_w, extra=1):
            psi_col = np.array([pow(base_psi, int(e), q) for e in i])
            wp = np.array([pow(base_w, int(e), q) for e in range(n)])
            exps = (i[:, None] * np.asarray(rev)[None, :]) % n
            return psi_col[:, None] * wp[exps] % q * extra % q

        F = powmat(p.psi or 1, p.omega)      # psi=0 (cyclic): no twist
        # inverse: G[pos, j] = psi^-j · n^-1 · omega^(-bitrev(pos)·j)
        Ginv = powmat(p.psi_inv or 1, p.omega_inv, modinv(p.n, q)).T
        self._F = self._limbs(F)
        self._G = self._limbs(Ginv)
        c14 = (1 << 2 * _LIMB) % q
        c7 = (1 << _LIMB) % q
        self._c14 = self.arith.const_table(np.array([c14]))
        self._c7 = self.arith.const_table(np.array([c7]))
        self._one = self.arith.const_table(np.array([1]))

    @staticmethod
    def _limbs(m: np.ndarray):
        """q<2^14 matrix -> (lo, hi) 7-bit limb planes as bf16."""
        lo = (m & _LMASK).astype(np.float32).astype(jnp.bfloat16)
        hi = (m >> _LIMB).astype(np.float32).astype(jnp.bfloat16)
        return lo, hi

    # ------------------------------------------------------------------

    def _apply(self, x, mat):
        """Exact (batch, n) x (n, n) modular matmul via 4 bf16 partials."""
        ar = self.arith
        q = self.params.q
        mlo, mhi = mat
        xlo = (x & jnp.int32(_LMASK)).astype(jnp.bfloat16)
        xhi = (x >> _LIMB).astype(jnp.bfloat16)

        def mm(a, b):
            r = jnp.dot(a, b, preferred_element_type=jnp.float32)
            return r.astype(jnp.int32)               # exact: < 2^24

        p00 = mm(xlo, mlo)
        p01 = mm(xlo, mhi)
        p10 = mm(xhi, mlo)
        p11 = mm(xhi, mhi)

        def red24(z):
            # z < 2^24: z ≡ (z>>14)·(2^14 mod q) + (z & 2^14-1); both halves
            # are < 2^15 so a Shoup constant-multiply canonicalises each
            # (Shoup by 1 is a pure range reduction)
            hi = z >> 14
            lo = z & jnp.int32((1 << 14) - 1)
            return ar.add(ar.mul_const(hi, self._c14),
                          ar.mul_const(lo, self._one))

        r00 = red24(p00)
        rmid = ar.add(red24(p01), red24(p10))
        r11 = red24(p11)
        out = ar.add(r00, ar.mul_const(rmid, self._c7))
        return ar.add(out, ar.mul_const(r11, self._c14))

    def forward(self, x):
        return self._apply(jnp.asarray(x, jnp.int32), self._F)

    def inverse(self, x):
        return self._apply(jnp.asarray(x, jnp.int32), self._G)

    def polymul(self, a, b):
        fa = self.forward(a)
        fb = self.forward(b)
        return self.inverse(self.arith.mul(fa, fb))

    @functools.cached_property
    def polymul_jit(self):
        return jax.jit(self.polymul)

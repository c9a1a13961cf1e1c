"""Multi-limb modular arithmetic for big moduli (q up to 2^62) in int32
int32 vector lanes.

The reference claims parametric K up to 64 bits by widening every datapath
wire (defines.v:42) and chunking the multiplier into 16-bit DSP partial
products (intMult.v:46-71).  The accelerator twin chunks into **15-bit limbs** so
every partial product and every accumulator provably stays below 2^31 in
int32 vector lanes.

This module provides the *accumulate-constant-multiples* form of big-q
arithmetic that the device-side Garner CRT needs (bigq.py):

    S = sum_t  v_t · c_t   (mod q),   v_t < 2^15 data,  c_t < q constants

Each partial v·c_limb is < 2^30 and is immediately split into a 15-bit
bucket and a carry bucket, so any number of terms accumulates without
overflow (bucket growth is 2^15 per term).  Reduction mod q is exact and
data-independent:

1. carry-propagate to canonical 15-bit limbs;
2. conditional shift-subtract ladder: for j = J .. 0 subtract 2^j·q
   when it fits (multi-limb borrow compare), with J tracked host-side
   from the term-count bound — the limb-vector analog of ModRed.v's
   final conditional subtract (ModRed.v:54-73), iterated.

Values cross the host boundary as two packed int32 planes per coefficient
(low/high 31 bits), see :func:`pack_u64_planes`/:func:`unpack_u64_planes`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["LimbArith", "pack_u64_planes", "unpack_u64_planes"]

_B = 15
_M15 = (1 << _B) - 1


def _to_limbs(c: int, nl: int) -> list[int]:
    """Host int -> nl 15-bit limbs (little-endian)."""
    out = []
    for _ in range(nl):
        out.append(c & _M15)
        c >>= _B
    assert c == 0, "constant does not fit in limb count"
    return out


def pack_u64_planes(x: np.ndarray, wide: bool = False) \
        -> tuple[np.ndarray, np.ndarray]:
    """uint64 host array -> two int32 planes.

    Default packing is (lo31, hi31) — covers q < 2^62 with both planes
    non-negative.  ``wide=True`` packs TRUE 32-bit halves (lo32, hi32) —
    covers the full 64-bit range the reference claims (defines.v:42,
    K up to 64); plane values may go negative as int32, downstream
    consumers extract 16-bit chunks with masks so the sign bit is just
    bit 31."""
    x = np.asarray(x, dtype=np.uint64)
    if wide:
        lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        hi = (x >> np.uint64(32)).astype(np.uint32).view(np.int32)
        return lo, hi
    lo = (x & np.uint64((1 << 31) - 1)).astype(np.int32)
    hi = (x >> np.uint64(31)).astype(np.int32)
    return lo, hi


def unpack_u64_planes(lo: np.ndarray, hi: np.ndarray,
                      wide: bool = False) -> np.ndarray:
    """Two int32 planes -> uint64 host array (inverse of
    :func:`pack_u64_planes`, same ``wide`` flag)."""
    shift = np.uint64(32 if wide else 31)
    lo_u = np.asarray(lo).view(np.uint32).astype(np.uint64) if wide \
        else np.asarray(lo).astype(np.uint64)
    hi_u = np.asarray(hi).view(np.uint32).astype(np.uint64) if wide \
        else np.asarray(hi).astype(np.uint64)
    return (hi_u << shift) | lo_u


class LimbArith:
    """Fixed-modulus accumulate/reduce engine over 15-bit limb planes.

    A value is a python list of same-shape int32 jnp arrays (limb planes,
    little-endian).  The accumulator is a pair of such lists (sum planes +
    carry planes) so accumulation never overflows int32.
    """

    def __init__(self, q: int):
        if not (2 < q < 1 << 64):
            raise ValueError("LimbArith needs 2 < q < 2^64")
        self.q = q
        self.bits = q.bit_length()
        self.L = -(-self.bits // _B)          # canonical limb count
        # q past 62 bits needs the wide (true 32-bit halves) plane
        # packing; below that the legacy non-negative (lo31, hi31) form
        self.wide = self.bits > 62

    # ------------------------------------------------------------------
    # accumulation
    # ------------------------------------------------------------------

    def zero_acc(self, shape, n_limbs: int):
        z = [jnp.zeros(shape, jnp.int32) for _ in range(n_limbs)]
        return [list(z), [jnp.zeros(shape, jnp.int32)
                          for _ in range(n_limbs)]]

    def acc_mul_const(self, acc, v15, c: int):
        """acc += v15 · c, with v15 int32 data in [0, 2^15] and host
        constant 0 <= c < q.  Partials split lo/carry immediately."""
        s, car = acc
        for j, cl in enumerate(_to_limbs(c % self.q, len(s))):
            if cl == 0:
                continue
            p = v15 * jnp.int32(cl)           # < 2^30
            s[j] = s[j] + (p & jnp.int32(_M15))
            if j + 1 < len(s):
                car[j + 1] = car[j + 1] + (p >> _B)

    # ------------------------------------------------------------------
    # reduction
    # ------------------------------------------------------------------

    def _carry_prop(self, planes):
        """In-place ripple: canonical 15-bit limbs + top residue limb."""
        out = list(planes)
        for j in range(len(out) - 1):
            c = out[j] >> _B
            out[j] = out[j] & jnp.int32(_M15)
            out[j + 1] = out[j + 1] + c
        return out

    def _cond_sub(self, planes, sub_limbs: list[int]):
        """planes -= sub (as limbs) when planes >= sub; borrow-chain
        compare, branchless select."""
        diff = []
        borrow = jnp.zeros_like(planes[0])
        for j in range(len(planes)):
            d = planes[j] - jnp.int32(sub_limbs[j] if j < len(sub_limbs)
                                      else 0) - borrow
            borrow = (d >> 31) & 1            # 1 if went negative
            diff.append(d + (borrow << _B))
        keep = borrow == 0                    # no final borrow: sub fits
        return [jnp.where(keep, d, p) for d, p in zip(diff, planes)]

    def finalize(self, acc, n_terms_bound: int):
        """Accumulator -> canonical limbs of the value mod q.

        ``n_terms_bound``: max number of acc_mul_const terms contributed
        (drives the host-side upper-bound tracking; exactness does not
        depend on it being tight, only on it being an upper bound).
        Reduction is a conditional shift-subtract ladder over 2^j·q —
        ~bits(ub/q) data-independent rounds, run once per output."""
        s, car = acc
        planes = [a + b for a, b in zip(s, car)]
        planes = self._carry_prop(planes)

        ub = n_terms_bound * (1 << _B) * (self.q - 1)
        if ub >= 1 << (_B * len(planes)):
            raise ValueError("accumulator has too few limb planes for "
                             f"{n_terms_bound} terms")
        J = max(0, (ub // self.q).bit_length())
        width = max(len(planes), -(-(self.bits + J) // _B))
        planes = planes + [jnp.zeros_like(planes[0])
                           for _ in range(width - len(planes))]
        for j in range(J, -1, -1):
            planes = self._cond_sub(planes, _to_limbs(self.q << j, width))
        return planes[:self.L]

    # ------------------------------------------------------------------
    # packing
    # ------------------------------------------------------------------

    def limbs_to_planes(self, limbs):
        """Canonical limbs (< q) -> two int32 planes, in this modulus's
        packing (``self.wide``: true 32-bit halves for 62 < bits(q) <= 64,
        else the legacy non-negative lo31/hi31)."""
        padded = limbs + [jnp.zeros_like(limbs[0])] * (5 - len(limbs))
        l0, l1, l2, l3, l4 = padded[:5]
        if self.wide:
            # bits 0..31 | 32..63 of l4..l0 (15-bit limbs); the shifts
            # into bit 31 wrap into the int32 sign bit, which is fine —
            # consumers are mask-based chunk extractors
            lo = l0 | (l1 << _B) | ((l2 & 3) << 30)
            hi = (l2 >> 2) | (l3 << 13) | (l4 << 28)
            return lo, hi
        lo = l0 | (l1 << _B) | ((l2 & 1) << 30)
        hi = (l2 >> 1) | (l3 << 14) | (l4 << 29)
        return lo, hi

    def planes_to_16bit(self, lo, hi):
        """Two packed planes -> four 16-bit chunks (c0..c3) such that
        value = c3·2^S3 + c2·2^S2 + c1·2^16 + c0 with (S2, S3) =
        (32, 48) wide / (31, 47) legacy — mask extraction, so int32
        sign bits in wide planes are handled for free."""
        c0 = lo & jnp.int32(0xFFFF)
        c2 = hi & jnp.int32(0xFFFF)
        if self.wide:
            c1 = (lo >> 16) & jnp.int32(0xFFFF)
            c3 = (hi >> 16) & jnp.int32(0xFFFF)
        else:
            c1 = (lo >> 16) & jnp.int32(0x7FFF)   # 15 bits (lo is 31 bits)
            c3 = (hi >> 16) & jnp.int32(0x7FFF)
        return c0, c1, c2, c3

    @property
    def chunk_shifts(self) -> tuple[int, int, int]:
        """Bit positions of chunks c1, c2, c3 in this packing."""
        return (16, 32, 48) if self.wide else (16, 31, 47)

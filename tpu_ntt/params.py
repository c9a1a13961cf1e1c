"""Parameter generation and twiddle-factor tables — the single config object.

The reference triplicates its constants across Verilog macros
(``Hardware_Multiplier/defines.v:25-59``), C ``#define``s
(``NTT_Software/Generator_Params/generate_params.h:8-11``) and Python globals
(``Hardware_Multiplier/test_generator/test_generator.py:52-113``), and keeps
them in sync by hand.  Here everything derives from one frozen
:class:`NTTParams` object.

Covers, on the accelerator side, what the reference spreads over:

- prime search / root-of-unity search
  (``test_generator/test_generator.py:83-109``,
  ``Generator_Params/generate_params.C:12-53``,
  ``test_generator/generate_prime.py``)
- the Montgomery-like hardware scale ``R = 2**(W_SIZE*L_SIZE)``
  (``defines.v:44-59``, ``test_generator.py:111``)
- the Longa–Naehrig decomposition ``q = 2^m * k + 1``
  (``NTT-RED/ntt_red.h:10-47``)
- every twiddle table used by the C software multipliers
  (``NTT-RED/ntt_red256_tables.h:31-49``, ``NTT/ntt256_tables.h``)
- the hardware twiddle-stream schedule
  (``test_generator.py:183-189``, ``generate_params.C:55-73``)
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from .utils.bitrev import bit_reverse_int

__all__ = [
    "NTTParams",
    "make_params",
    "find_params",
    "modinv",
    "is_prime",
    "find_root_of_order",
    "psi_powers",
    "stage_powers",
    "hw_twiddle_stream",
    "to_shifted",
    "PRESETS",
    "preset",
]


# ---------------------------------------------------------------------------
# Number theory (host-side, exact Python ints)
# ---------------------------------------------------------------------------

def modinv(a: int, m: int) -> int:
    """Modular inverse via extended gcd (helper.py:23-35 twin)."""
    g, x = _egcd(a % m, m)
    if g != 1:
        raise ValueError(f"{a} is not invertible modulo {m}")
    return x % m


def _egcd(a: int, b: int) -> tuple[int, int]:
    old_r, r = a, b
    old_s, s = 1, 0
    while r:
        qt = old_r // r
        old_r, r = r, old_r - qt * r
        old_s, s = s, old_s - qt * s
    return old_r, old_s


_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller–Rabin for n < 3.3e24 (generate_prime.py:19-42 twin)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_prime(bits: int, n: int, negacyclic: bool = True) -> int:
    """Smallest ``bits``-bit prime q with q ≡ 1 (mod 2n) (or mod n if cyclic).

    Deterministic (smallest qualifying q) rather than the reference's random
    search (test_generator.py:83-88) so results are reproducible.
    """
    step = 2 * n if negacyclic else n
    q = (1 << (bits - 1)) // step * step + 1
    while q < (1 << bits):
        if q > (1 << (bits - 1)) and is_prime(q):
            return q
        q += step
    raise ValueError(f"no {bits}-bit prime ≡ 1 mod {step}")


def find_root_of_order(order: int, q: int) -> int:
    """Smallest primitive ``order``-th root of unity mod prime q.

    Twin of the psi search in test_generator.py:91-99 /
    generate_params.C:25-44, but done the standard way: pick a generator
    candidate g, check g^(order/p) != 1 for every prime p | order.
    """
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide q-1={q - 1}")
    cof = (q - 1) // order
    factors = _prime_factors(order)
    for g in range(2, q):
        r = pow(g, cof, q)
        if r == 1:
            continue
        if all(pow(r, order // p, q) != 1 for p in factors):
            return r
    raise ValueError("no primitive root found")


def _prime_factors(x: int) -> list[int]:
    out = []
    d = 2
    while d * d <= x:
        if x % d == 0:
            out.append(d)
            while x % d == 0:
                x //= d
        d += 1
    if x > 1:
        out.append(x)
    return out


# ---------------------------------------------------------------------------
# The config object
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NTTParams:
    """All parameters of one NTT instance over Z_q[x]/(x^n ± 1).

    One object replaces defines.v (K, n, PE and derived macros), the C
    parameter headers and the Python generator globals.
    """

    n: int                 # ring size (power of two)
    q: int                 # prime modulus, q ≡ 1 mod n (mod 2n if psi != 0)
    omega: int             # primitive n-th root of unity mod q
    psi: int = 0           # primitive 2n-th root with psi^2 = omega; 0 = cyclic only

    # -- derived (filled by __post_init__) --
    omega_inv: int = 0
    psi_inv: int = 0
    n_inv: int = 0

    def __post_init__(self):
        if self.n & (self.n - 1):
            raise ValueError("n must be a power of two")
        if pow(self.omega, self.n, self.q) != 1:
            raise ValueError("omega is not an n-th root of unity")
        if self.psi and pow(self.psi, 2, self.q) != self.omega:
            raise ValueError("psi^2 != omega")
        object.__setattr__(self, "omega_inv", modinv(self.omega, self.q))
        object.__setattr__(self, "psi_inv",
                           modinv(self.psi, self.q) if self.psi else 0)
        object.__setattr__(self, "n_inv", modinv(self.n, self.q))

    # -- geometry --
    @property
    def log2n(self) -> int:
        return self.n.bit_length() - 1

    @property
    def k_bits(self) -> int:
        """Coefficient bit width K (defines.v:25)."""
        return (self.q - 1).bit_length()

    @property
    def negacyclic(self) -> bool:
        return self.psi != 0

    # -- Longa–Naehrig decomposition q = 2^m * k + 1 (ntt_red.h:10-47) --
    @property
    def ln_m(self) -> int:
        return ((self.q - 1) & -(self.q - 1)).bit_length() - 1

    @property
    def ln_k(self) -> int:
        return (self.q - 1) >> self.ln_m

    @property
    def ln_mask(self) -> int:
        return (1 << self.ln_m) - 1

    @property
    def k_inv(self) -> int:
        """Inverse of the LN constant k mod q (= 8193 for q=12289)."""
        return modinv(self.ln_k, self.q)

    # -- hardware word-level reduction scale (defines.v:44-59) --
    @property
    def w_size(self) -> int:
        return self.log2n + 1

    @property
    def l_size(self) -> int:
        return math.ceil(self.k_bits / self.w_size)

    @property
    def R(self) -> int:
        """R = 2^(W_SIZE*L_SIZE), the Mert-style scale (test_generator.py:111)."""
        return 1 << (self.w_size * self.l_size)


def make_params(n: int, q: int, negacyclic: bool = True) -> NTTParams:
    """Build params for a given (n, q), searching for the roots."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    if negacyclic and (q - 1) % (2 * n) == 0:
        psi = find_root_of_order(2 * n, q)
        return NTTParams(n=n, q=q, omega=pow(psi, 2, q), psi=psi)
    if (q - 1) % n != 0:
        raise ValueError(f"q={q} supports no size-{n} NTT")
    return NTTParams(n=n, q=q, omega=find_root_of_order(n, q), psi=0)


def find_params(n: int, k_bits: int, negacyclic: bool = True) -> NTTParams:
    """Search a k-bit NTT-friendly prime then build params
    (test_generator.py:83-113 twin)."""
    q = find_ntt_prime(k_bits, n, negacyclic)
    return make_params(n, q, negacyclic)


# ---------------------------------------------------------------------------
# Twiddle tables
# ---------------------------------------------------------------------------
#
# Table layout convention (shared by all eight C NTT variants,
# ntt_red.h:159-284): a flat length-n array p with the stage-t block at
# offset t:   p[t + j],  t = 1, 2, 4, ..., n/2,  j = 0..t-1,  p[0] unused.
#
# For each variant the per-stage generator is g_t = base^(n/2t); entries are
# g_t^j ("std" order) or g_t^bitrev_t(j) ("rev" order), optionally premultiplied
# by a psi factor psi_b^(n/2t) ("mixed" tables) and by a global scale
# (inverse(3) for the Longa–Naehrig tables, R for the hardware stream).


def to_shifted(a: np.ndarray, q: int) -> np.ndarray:
    """Canonical [0,q) -> shifted signed [-(q-1)/2, (q-1)/2]
    (ntt_red.c:103-111 twin, applied to tables)."""
    a = np.asarray(a, dtype=np.int64)
    return np.where(a > (q - 1) // 2, a - q, a)


def psi_powers(p: NTTParams, base: int | None = None, scale: int = 1,
               shifted: bool = False) -> np.ndarray:
    """``out[i] = base^i * scale mod q`` — the psi-power twist tables.

    - base=psi,     scale=1            -> ntt256_psi_powers (plain)
    - base=psi,     scale=k_inv        -> ntt_red256_psi_powers
    - base=psi_inv, scale=n_inv*k_inv^8 -> ntt_red256_scaled_inv_psi_powers
    """
    if base is None:
        base = p.psi
    out = np.empty(p.n, dtype=np.int64)
    acc = scale % p.q
    for i in range(p.n):
        out[i] = acc
        acc = acc * base % p.q
    return to_shifted(out, p.q) if shifted else out


def stage_powers(p: NTTParams, base: int | None = None, rev: bool = False,
                 psi_base: int = 0, scale: int = 1,
                 shifted: bool = False) -> np.ndarray:
    """The flat stage-indexed twiddle table p[t+j] described above.

    ``p[t + j] = psi_base^(n/2t) * (base^(n/2t))^e(j) * scale  mod q``
    with e(j) = bitrev_{log2 t}(j) if rev else j.  p[0] = 0 (unused).

    Matches the eight table conventions of ntt_red.h:159-284 / ntt.h.
    """
    if base is None:
        base = p.omega
    out = np.zeros(p.n, dtype=np.int64)
    t = 1
    while t < p.n:
        g = pow(base, p.n // (2 * t), p.q)
        pre = pow(psi_base, p.n // (2 * t), p.q) if psi_base else 1
        bits = t.bit_length() - 1
        for j in range(t):
            e = bit_reverse_int(j, bits) if rev else j
            out[t + j] = pre * pow(g, e, p.q) % p.q * scale % p.q
        t <<= 1
    return to_shifted(out, p.q) if shifted else out


# -- named table sets ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cached_tables(p: NTTParams, red: bool) -> dict[str, np.ndarray]:
    """The full 12-table set of ntt_red256_tables.h (red=True) or the
    unscaled uint tables of ntt256_tables.h (red=False)."""
    q = p.q
    s = p.k_inv if red else 1          # inverse(3) folded into RED tables
    sh = red                           # RED tables are stored shifted signed
    inv_n_scale = p.n_inv * pow(p.k_inv if red else 1, 8, q) % q
    # ^ scaled_inv_psi_powers folds n^-1 and k^-8: product1 accumulates
    #   k^5 (twist k^0, fwd reduce k^1 each => k^2, pointwise mul_red k^1,
    #   reduce_twice k^2) and applies k^3 after the table (mul_red k^1,
    #   reduce_twice k^2), so the table must carry k^-8 (ntt_red256.C:5-27).
    return {
        "psi_powers": psi_powers(p, p.psi, s, sh),
        "inv_psi_powers": psi_powers(p, p.psi_inv, s, sh),
        "scaled_inv_psi_powers": psi_powers(p, p.psi_inv, inv_n_scale, sh),
        "omega_powers": stage_powers(p, p.omega, False, 0, s, sh),
        "omega_powers_rev": stage_powers(p, p.omega, True, 0, s, sh),
        "inv_omega_powers": stage_powers(p, p.omega_inv, False, 0, s, sh),
        "inv_omega_powers_rev": stage_powers(p, p.omega_inv, True, 0, s, sh),
        "mixed_powers": stage_powers(p, p.omega, False, p.psi, s, sh),
        "mixed_powers_rev": stage_powers(p, p.omega, True, p.psi, s, sh),
        "inv_mixed_powers": stage_powers(p, p.omega_inv, False, p.psi_inv, s, sh),
        "inv_mixed_powers_rev": stage_powers(p, p.omega_inv, True, p.psi_inv, s, sh),
    }


def tables(p: NTTParams, red: bool = False) -> dict[str, np.ndarray]:
    """All twiddle tables for params ``p``.

    red=False: canonical [0,q) tables (ntt256_tables.h conventions).
    red=True:  Longa–Naehrig tables with inverse(k) folded in, shifted signed
               (ntt_red256_tables.h conventions).
    """
    return dict(_cached_tables(p, red))


# -- hardware twiddle stream ----------------------------------------------

def hw_twiddle_stream(p: NTTParams, pe: int, inverse: bool = False,
                      r_scaled: bool = True) -> np.ndarray:
    """The mode-0 hardware twiddle schedule W / WINV.

    For stage j, butterfly-group k, PE i the hardware consumes
    ``omega^(((PE<<j)*k + (i<<j)) mod (n/2))`` pre-scaled by R mod q —
    exactly test_generator.py:183-189 / generate_params.C:55-73.
    Length = ((2^(log2n - log2PE) - 1) + log2PE) * PE  (272 for n=256, PE=8).
    """
    base = p.omega_inv if inverse else p.omega
    scale = p.R % p.q if r_scaled else 1
    two_pe = 2 * pe
    out = []
    for j in range(p.log2n):
        groups = max(1, (p.n // two_pe) >> j)
        for k in range(groups):
            for i in range(pe):
                w_pow = ((pe << j) * k + (i << j)) % (p.n // 2)
                out.append(pow(base, w_pow, p.q) * scale % p.q)
    return np.array(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# Presets — the reference's parameter menu
# ---------------------------------------------------------------------------

def _preset_factory():
    # (n, q, psi) points from the reference where available:
    # - NewHope-style SW point: n=256 q=12289 psi=1002 (ntt_red256_tables.h:1-12)
    # - Hardware point: n=256 q=7681 (defines.v:25-27, PolyMult.v:282)
    # - Menu of larger sets: test_generator.py:52-63
    fixed = {
        "sw256": (256, 12289, 1002),
        # psi=62 is what the reference's smallest-root search lands on
        # (test_generator.py:91-99); pinned for golden-vector parity
        # (simulation/modelsim/test/PARAM.txt: w=0xf04=3844=62^2 mod 7681).
        "hw256": (256, 7681, 62),
        "kyber128": (128, 3329, None),       # q-1 = 2^8*13: full negacyclic at n=128
        "dilithium256": (256, 8380417, None),
        "n1024_k19": (1024, 520193, 98),
        "n1024_k27": (1024, 132120577, 73993),
        "n1024_k29": (1024, 463128577, 61961),
        "n2048_k30": (2048, 618835969, 327404),
        "n2048_k37": (2048, 137438691329, 22157790),
        "n4096_k25": (4096, 33349633, 8131),
        "n4096_k36": (4096, 68719230977, 29008497),
        "n4096_k55": (4096, 36028797009985537, 5947090524825),
        "n8192_k43": (8192, 8796092858369, 1734247217),
        "n16384_k49": (16384, 562949951881217, 45092463253),
        "n16384_k50": (16384, 1125899903500289, 68423600398),
        "n32768_k55": (32768, 36028797009985537, 5947090524825),
        # large-transform configs (BASELINE.json): goldilocks 2^64-2^32+1 is
        # not prime-representable in 62 bits; use a 62-bit NTT prime instead.
        "n65536_k62": (65536, None, None),
        "n1048576_k62": (1 << 20, None, None),
    }
    return fixed


_PRESET_POINTS = _preset_factory()
PRESETS = tuple(_PRESET_POINTS)


@functools.lru_cache(maxsize=None)
def preset(name: str) -> NTTParams:
    """Look up a named parameter preset (test_generator.py:52-81 menu)."""
    n, q, psi = _PRESET_POINTS[name]
    if q is None:
        return find_params(n, 62, negacyclic=True)
    if psi is not None and pow(psi, n, q) == q - 1:
        return NTTParams(n=n, q=q, omega=pow(psi, 2, q), psi=psi)
    # some reference menu entries (test_generator.py:52-63) reuse a psi whose
    # order doesn't match the listed n; search a proper root instead
    return make_params(n, q, negacyclic=(q - 1) % (2 * n) == 0)

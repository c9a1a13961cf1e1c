"""Pure NumPy bit-exact oracle for every transform the reference implements.

This module is the rebuild's *semantics anchor*: the NumPy twin of

- the schoolbook golden models
  (``NTT_Software/colab_programs/schoolbook.py:23-46`` negacyclic;
  cyclic analog used by the hardware flow),
- the eight plain NTT variants of ``NTT_Software/.../NTT/ntt.C`` (exact
  ``modq``/``add_mod``/``sub_mod`` arithmetic, canonical [0,q) values),
- the eight Longa–Naehrig lazy-reduction variants of
  ``NTT_Software/.../NTT-RED/ntt_red.c`` (exact int32 semantics, including
  the ×k scale factors and the skipped multiply at j=0),
- the full products ``ntt256_product1/4`` (``NTT/ntt256.C:5-23``) and
  ``ntt_red256_product1/4`` (``NTT-RED/ntt_red256.C:5-52``),
- the hardware golden model ``IterativeForwardNTT``/``IterativeInverseNTT``
  (``Hardware_Multiplier/test_generator/helper.py:52-206``) and the PolyMult
  mode-3 "GO" pipeline (``Hardware_Multiplier/PolyMult.v:176-267``).

Everything here is loop-light vectorised NumPy but *bit-exact* with the C:
each butterfly stage is one sliced array op, mirroring how the JAX/Pallas
compute path is organised.  The JAX implementations are tested against this
module; this module is tested against the reference's checked-in vectors and
(when a C compiler is available) the compiled C sources themselves.
"""

from __future__ import annotations

import numpy as np

from .params import NTTParams, tables
from .utils.bitrev import bit_reverse_permute

__all__ = [
    "schoolbook_negacyclic", "schoolbook_cyclic",
    "ntt", "NTT_VARIANTS", "ntt_ct_rev2std_v1",
    "red", "mul_red", "shift", "correct",
    "ntt_red", "product_red", "product_plain",
    "hw_ntt", "hw_intt", "hw_polymul",
]


# ---------------------------------------------------------------------------
# Schoolbook golden models (exact, O(n^2))
# ---------------------------------------------------------------------------

def schoolbook_negacyclic(a, b, q: int) -> np.ndarray:
    """Product in Z_q[x]/(x^n + 1): res[k] = (conv[k] - conv[k+n]) mod q
    (schoolbook.py:23-46 twin)."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    n = len(a)
    conv = np.zeros(2 * n, dtype=object)
    for i in range(n):
        conv[i:i + n] += a[i] * b
    out = [(int(conv[k]) - int(conv[k + n])) % q for k in range(n)]
    # int64 result for every classic modulus; object past 2^62 (64-bit
    # moduli produce residues int64 cannot hold)
    return np.array(out, dtype=np.int64 if q < 1 << 62 else object)


def schoolbook_rows(a, b, q: int, negacyclic: bool = True) -> np.ndarray:
    """Row-wise products of two (batch, n) arrays in Z_q[x]/(x^n ± 1),
    vectorised over the batch in int64 — the schoolbook above for whole
    benchmark batches.  Exact while n·(q-1)² < 2^63."""
    a = np.asarray(a, dtype=np.int64)
    b = np.asarray(b, dtype=np.int64)
    n = a.shape[-1]
    if n * (q - 1) ** 2 >= 1 << 63:
        raise ValueError(f"n={n}, q={q}: int64 convolution would overflow")
    conv = np.zeros(a.shape[:-1] + (2 * n,), dtype=np.int64)
    for i in range(n):
        conv[..., i:i + n] += a[..., i:i + 1] * b
    lo, hi = conv[..., :n], conv[..., n:]
    return (lo - hi if negacyclic else lo + hi) % q


def schoolbook_cyclic(a, b, q: int) -> np.ndarray:
    """Product in Z_q[x]/(x^n - 1): res[k] = (conv[k] + conv[k+n]) mod q —
    what the hardware mode-3 flow computes (it never applies the psi twist;
    PolyMult.v:176-238)."""
    a = np.asarray(a, dtype=object)
    b = np.asarray(b, dtype=object)
    n = len(a)
    conv = np.zeros(2 * n, dtype=object)
    for i in range(n):
        conv[i:i + n] += a[i] * b
    out = [(int(conv[k]) + int(conv[k + n])) % q for k in range(n)]
    return np.array(out, dtype=np.int64 if q < 1 << 62 else object)


# ---------------------------------------------------------------------------
# Generic iterative NTT — the eight order/butterfly variants, canonical mod q
# ---------------------------------------------------------------------------
#
# Stage geometry (shared with ntt.C / ntt_red.c):
#   CT ("DIT" butterfly  lo' = lo + w*hi, hi' = lo - w*hi):
#     rev2std: t = 1..n/2 doubling; pairs (s, s+t), s stepping 2t, twiddle by j
#     std2rev: t = 1..n/2 doubling; d = n/2t; pairs (s, s+d) in block u=2dj
#   GS ("DIF" butterfly  lo' = lo + hi,  hi' = (lo - hi)*w):
#     rev2std: d = 1..n/2 doubling; t = n/2d; pairs in block u=2dj
#     std2rev: t = n/2..1 halving;  pairs (s, s+t), s stepping 2t, twiddle by j
#
# All four reshape to a (blocks, 2, width) view where the butterfly is one
# vectorised op — exactly the shape the XLA plans use.


def _view(a: np.ndarray, width: int) -> np.ndarray:
    return a.reshape(-1, 2, width)


def ntt(a, p: NTTParams, kind: str = "ct", order: str = "std2rev",
        inverse: bool = False, mixed: bool = False,
        table: np.ndarray | None = None) -> np.ndarray:
    """Generic canonical-arithmetic NTT (every value kept in [0,q)).

    kind:    "ct" (Cooley-Tukey/DIT) or "gs" (Gentleman-Sande/DIF)
    order:   "std2rev" or "rev2std"
    inverse: use omega^-1 stage tables (no n^-1 scaling — callers fold that
             into a psi table or apply it separately, as the C does)
    mixed:   fold the psi twist into stage twiddles (mulntt_* variants);
             the j=0 butterfly then multiplies too (ntt.C:253-278).

    Bit-exact twin of ntt.C:168-525 for int32-safe q.
    """
    q = p.q
    if table is None:
        t_ = tables(p)
        key = ("inv_" if inverse else "") + ("mixed" if mixed else "omega") + "_powers"
        # std2rev CT and rev2std GS consume the *_rev tables (ntt_red256.h:21-52)
        if (kind, order) in (("ct", "std2rev"), ("gs", "rev2std")):
            key += "_rev"
        table = t_[key]
    w = np.asarray(table, dtype=np.int64)
    a = np.asarray(a, dtype=np.int64).copy()
    n = p.n

    def stage_ct(x, width, tw):
        lo, hi = x[:, 0, :], x[:, 1, :]
        m = hi * tw % q
        return np.stack([(lo + m) % q, (lo - m) % q], axis=1)

    def stage_gs(x, width, tw):
        lo, hi = x[:, 0, :], x[:, 1, :]
        return np.stack([(lo + hi) % q, (lo - hi) * tw % q], axis=1)

    if kind == "ct":
        ts = [1 << i for i in range(p.log2n)]
        for t in ts:
            tw = w[t:2 * t]
            if not mixed:
                tw = tw.copy()
                tw[0] = 1          # j=0 butterfly skips the multiply
            if order == "rev2std":
                # pairs (s, s+t), twiddle indexed by position within block
                x = _view(a, t)                       # (n/2t, 2, t)
                a = stage_ct(x, t, tw[None, :]).reshape(n)
            else:
                # std2rev: d = n/2t, block j at rows [2dj, 2dj+2d)
                d = n // (2 * t)
                x = _view(a, d)                       # (t, 2, d)
                a = stage_ct(x, d, tw[:, None]).reshape(n)
    elif kind == "gs":
        if order == "std2rev":
            t = n // 2
            while t > 0:
                tw = w[t:2 * t] if t > 0 else w[:0]
                if not mixed:
                    tw = tw.copy()
                    tw[0] = 1
                x = _view(a, t)                       # (n/2t, 2, t)
                a = stage_gs(x, t, tw[None, :]).reshape(n)
                t >>= 1
        else:
            d = 1
            while d < n:
                t = n // (2 * d)
                tw = w[t:2 * t]
                if not mixed:
                    tw = tw.copy()
                    tw[0] = 1
                x = _view(a, d)                       # (t, 2, d)
                a = stage_gs(x, d, tw[:, None]).reshape(n)
                d <<= 1
    else:
        raise ValueError(kind)
    return a


#: The eight (kind, order) variants of ntt.h:59-183 by name.
NTT_VARIANTS = {
    "ct_rev2std": ("ct", "rev2std"),
    "ct_std2rev": ("ct", "std2rev"),
    "gs_rev2std": ("gs", "rev2std"),
    "gs_std2rev": ("gs", "std2rev"),
}


def ntt_ct_rev2std_v1(a, p: NTTParams, inverse: bool = False) -> np.ndarray:
    """The ninth plain variant (``ntt.C:168`` ``ntt_ct_rev2std_v1``):
    the same CT rev2std transform, but the stage twiddle for round t,
    position j is read from the *full psi-powers array* at index j·l with
    l = n/t — ``w = p[j*l]  // w_t^j = psi^(l*j)`` — instead of the
    compact per-stage table ``p[t+j]`` of version 2.

    Since psi² = omega, psi^(l·j) = omega^((n/2t)·j): the two versions
    compute identical values; only the table layout/indexing differs.
    Exposed by name for inventory parity; pinned against the shared
    variant in tests.
    """
    t_ = tables(p)
    psi_pow = np.asarray(
        t_["inv_psi_powers" if inverse else "psi_powers"], dtype=np.int64)
    n = p.n
    # materialise the v1 indexing into the compact w[t+j] layout the
    # generic engine consumes: w[t+j] = psi_pow[j * (n // t)]
    w = np.zeros(n, dtype=np.int64)
    t = 1
    while t < n:
        l = n // t
        j = np.arange(t)
        w[t:2 * t] = psi_pow[(j * l) % n]
        t <<= 1
    return ntt(a, p, "ct", "rev2std", table=w)


# ---------------------------------------------------------------------------
# Longa–Naehrig lazy-reduction arithmetic (exact int32 semantics)
# ---------------------------------------------------------------------------

def red(x, p: NTTParams) -> np.ndarray:
    """red(x) = k*(x & mask) - (x >> m) ≡ k*x (mod q) — ntt_red.c:34-37 twin.
    Exact int32 wraparound semantics (numpy int32 ops)."""
    x = np.asarray(x, dtype=np.int32)
    return (np.int32(p.ln_k) * (x & np.int32(p.ln_mask))
            - (x >> np.int32(p.ln_m)))


def mul_red(x, y, p: NTTParams) -> np.ndarray:
    """red of the 64-bit product x*y, truncated to int32 — ntt_red.c:39-46."""
    z = np.asarray(x, dtype=np.int64) * np.asarray(y, dtype=np.int64)
    lo = (z & np.int64(p.ln_mask)).astype(np.int32)
    hi = (z >> np.int64(p.ln_m)).astype(np.int32)
    return np.int32(p.ln_k) * lo - hi


def shift(a, p: NTTParams) -> np.ndarray:
    """[0,q) -> [-(q-1)/2, (q-1)/2] — shift_array (ntt_red.c:103-111)."""
    a = np.asarray(a, dtype=np.int32)
    return np.where(a > (p.q - 1) // 2, a - np.int32(p.q), a)


def correct(a, p: NTTParams) -> np.ndarray:
    """[-q, 2q) -> [0,q) branchless — ntt_red.c:150-169."""
    x = np.asarray(a, dtype=np.int32)
    q = np.int32(p.q)
    x = x + ((x >> np.int32(16)) & q)
    x = x - q
    x = x + ((x >> np.int32(16)) & q)
    return x


def ntt_red(a, p: NTTParams, kind: str = "ct", order: str = "std2rev",
            inverse: bool = False, mixed: bool = False,
            table: np.ndarray | None = None) -> np.ndarray:
    """The eight lazy-reduction variants of ntt_red.c:244-554, bit-exact.

    Values are unreduced int32; tables carry the inverse(k) factor so each
    mul_red is scale-neutral; the j=0 butterfly skips the multiply entirely
    (unless ``mixed``).
    """
    if table is None:
        t_ = tables(p, red=True)
        key = ("inv_" if inverse else "") + ("mixed" if mixed else "omega") + "_powers"
        if (kind, order) in (("ct", "std2rev"), ("gs", "rev2std")):
            key += "_rev"
        table = t_[key]
    w = np.asarray(table, dtype=np.int64)
    a = np.asarray(a, dtype=np.int32).copy()
    n = p.n

    def stage_ct(x, tw, mul_mask):
        lo, hi = x[:, 0, :], x[:, 1, :]
        m = np.where(mul_mask, mul_red(hi, tw, p), hi)
        return np.stack([lo + m, lo - m], axis=1)

    def stage_gs(x, tw, mul_mask):
        lo, hi = x[:, 0, :], x[:, 1, :]
        d = lo - hi
        return np.stack([lo + hi, np.where(mul_mask, mul_red(d, tw, p), d)],
                        axis=1)

    def masks(t):
        # j=0 skips mul for plain variants; mixed variants always multiply
        m = np.ones(t, dtype=bool)
        if not mixed:
            m[0] = False
        return m

    if kind == "ct":
        for i in range(p.log2n):
            t = 1 << i
            tw, mk = w[t:2 * t], masks(t)
            if order == "rev2std":
                a = stage_ct(_view(a, t), tw[None, :], mk[None, :]).reshape(n)
            else:
                d = n // (2 * t)
                a = stage_ct(_view(a, d), tw[:, None], mk[:, None]).reshape(n)
    else:
        if order == "std2rev":
            t = n // 2
            while t > 0:
                tw, mk = w[t:2 * t], masks(t)
                a = stage_gs(_view(a, t), tw[None, :], mk[None, :]).reshape(n)
                t >>= 1
        else:
            d = 1
            while d < n:
                t = n // (2 * d)
                tw, mk = w[t:2 * t], masks(t)
                a = stage_gs(_view(a, d), tw[:, None], mk[:, None]).reshape(n)
                d <<= 1
    return a


# ---------------------------------------------------------------------------
# Full products
# ---------------------------------------------------------------------------

def product_red(a, b, p: NTTParams, kind: str = "ct") -> np.ndarray:
    """Negacyclic product with Longa–Naehrig lazy reduction.

    kind="ct" is ntt_red256_product1, kind="gs" is ntt_red256_product4
    (ntt_red256.C:5-52), generalised to any (n, q) with q = 2^m*k+1.
    Bit-exact for q=12289.
    """
    t_ = tables(p, red=True)
    inv_kind = kind                      # product1: CT fwd + CT inv; product4: GS+GS

    def fwd(x):
        x = shift(x, p)
        x = mul_red(x, t_["psi_powers"], p)
        x = ntt_red(x, p, kind, "std2rev")
        return red(x, p)

    fa, fb = fwd(a), fwd(b)
    c = mul_red(fa, fb, p)
    c = red(red(c, p), p)
    c = ntt_red(c, p, inv_kind, "rev2std", inverse=True)
    c = mul_red(c, t_["scaled_inv_psi_powers"], p)
    c = red(red(c, p), p)
    return correct(c, p)


def product_plain(a, b, p: NTTParams, kind: str = "ct") -> np.ndarray:
    """Negacyclic product with canonical arithmetic.

    kind="ct" is ntt256_product1, kind="gs" is ntt256_product4
    (NTT/ntt256.C:5-23), generalised to any (n, q).
    """
    t_ = tables(p)
    q = p.q
    psi_pow = t_["psi_powers"]
    scaled_inv = psi_powers_scaled_plain(p)

    def fwd(x):
        x = np.asarray(x, dtype=np.int64) * psi_pow % q
        return ntt(x, p, kind, "std2rev")

    fa, fb = fwd(a), fwd(b)
    c = fa * fb % q
    c = ntt(c, p, kind, "rev2std", inverse=True)
    return c * scaled_inv % q


def psi_powers_scaled_plain(p: NTTParams) -> np.ndarray:
    """psi^-i * n^-1 mod q — ntt256_scaled_inv_psi_powers."""
    from .params import psi_powers as _pp
    return _pp(p, p.psi_inv, p.n_inv)


# ---------------------------------------------------------------------------
# Hardware golden model (cyclic flow, q=7681 point)
# ---------------------------------------------------------------------------

def hw_ntt(a, p: NTTParams) -> np.ndarray:
    """The FPGA's NTT: GS/DIF butterflies, natural-order in, bit-reversed out
    (helper.py:52-121; NTT2.v:26-63 butterfly). Identical to
    ntt(kind="gs", order="std2rev") with plain omega stage twiddles."""
    return ntt(a, p, "gs", "std2rev",
               table=stage_powers_plain(p, inverse=False))


def hw_intt(a, p: NTTParams) -> np.ndarray:
    """The FPGA's INTT: same loop with omega^-1 plus a final n^-1 scaling
    pass (helper.py:124-206; NTTN.v state 5 at NTTN.v:448-479).
    Natural-order in, bit-reversed out."""
    out = ntt(a, p, "gs", "std2rev",
              table=stage_powers_plain(p, inverse=True))
    return out * np.int64(p.n_inv) % p.q


def stage_powers_plain(p: NTTParams, inverse: bool) -> np.ndarray:
    from .params import stage_powers as _sp
    return _sp(p, p.omega_inv if inverse else p.omega, rev=False)


def hw_polymul(a, b, p: NTTParams) -> np.ndarray:
    """The PolyMult mode-3 "GO" pipeline (PolyMult.v:176-267):

    NTT(A), NTT(B) (both bit-rev out) -> pointwise mod-q product
    (PolyPointwiseMult.v:101-127) -> bit-reverse back to natural order
    (PolyMult.v:81-87,222-227) -> INTT (bit-rev out) -> un-reverse on capture
    (NTT_PolyMul_test.v:204-225).

    Computes the *cyclic* product (no psi twist anywhere in the RTL flow).
    """
    fa = hw_ntt(a, p)
    fb = hw_ntt(b, p)
    c = fa * fb % p.q                       # both operands bit-reversed: aligned
    c = bit_reverse_permute(c)              # back to natural order for INTT
    c = hw_intt(c, p)
    return bit_reverse_permute(c)           # testbench un-reversal

// nttcore — native host-side runtime for tpu-ntt.
//
// The accelerator library's analog of the reference's C software stack
// (NTT_Software/NTT-RED, NTT) and host application layer: everything the
// host must do fast that XLA should not (64-bit modular arithmetic via
// __int128, RNS residue splitting, Garner CRT reconstruction with signed
// centering, and an independent uint64 NTT oracle for any q < 2^62).
// Loaded from Python through ctypes (runtime/native.py), mirroring how the
// reference dlopen()s its driver library (linux_app/PCIE.c:59-103) — but
// this is a from-scratch implementation, not a port.
//
// Build: make -C csrc   ->  libnttcore.so

#include <cstdint>
#include <cstddef>
#include <cstring>

using u64 = uint64_t;
using u128 = unsigned __int128;

extern "C" {

// ---------------------------------------------------------------------------
// 64-bit modular primitives
// ---------------------------------------------------------------------------

u64 ntt_mulmod64(u64 a, u64 b, u64 q) {
    return (u64)((u128)a * b % q);
}

u64 ntt_powmod64(u64 base, u64 exp, u64 q) {
    u64 r = 1 % q;
    base %= q;
    while (exp) {
        if (exp & 1) r = ntt_mulmod64(r, base, q);
        base = ntt_mulmod64(base, base, q);
        exp >>= 1;
    }
    return r;
}

u64 ntt_invmod64(u64 a, u64 q) {        // q prime
    return ntt_powmod64(a, q - 2, q);
}

// overflow-safe a+b / a-b mod q for a, b < q and ANY q < 2^64 (a + b can
// wrap u64 when q > 2^63 — the wrap is detected as s < a)
static inline u64 addmod64(u64 a, u64 b, u64 q) {
    u64 s = a + b;
    if (s < a || s >= q) s -= q;
    return s;
}

static inline u64 submod64(u64 a, u64 b, u64 q) {
    return a >= b ? a - b : a + (q - b);
}

// ---------------------------------------------------------------------------
// Reference iterative NTT over uint64 (any q < 2^64; butterfly add/sub
// are wrap-aware so q past 2^63 is exact) — the big-q oracle.
// Forward: Cooley-Tukey std2rev (natural in, bit-reversed out).
// Inverse: Gentleman-Sande rev2std (bit-reversed in, natural out), n^-1
// folded by the caller or via ntt_polymul64 below.
// Same stage geometry as the int32 XLA path (see tpu_ntt/transform.py).
// ---------------------------------------------------------------------------

static void fwd_ct_std2rev(u64* a, size_t n, u64 q, const u64* stage_tw) {
    // stage_tw: flat table p[t+j] = w_t^bitrev(j) (optionally psi-merged),
    // p[0] unused — same layout as ntt_red.h:159-217.
    for (size_t t = 1; t < n; t <<= 1) {
        size_t d = n / (2 * t);
        for (size_t j = 0; j < t; j++) {
            u64 w = stage_tw[t + j];
            u64* blk = a + 2 * d * j;
            for (size_t s = 0; s < d; s++) {
                u64 x = ntt_mulmod64(blk[s + d], w, q);
                u64 lo = blk[s];
                blk[s + d] = submod64(lo, x, q);
                blk[s] = addmod64(lo, x, q);
            }
        }
    }
}

static void inv_gs_rev2std(u64* a, size_t n, u64 q, const u64* stage_tw) {
    for (size_t d = 1; d < n; d <<= 1) {
        size_t t = n / (2 * d);
        for (size_t j = 0; j < t; j++) {
            u64 w = stage_tw[t + j];
            u64* blk = a + 2 * d * j;
            for (size_t s = 0; s < d; s++) {
                u64 lo = blk[s], hi = blk[s + d];
                blk[s] = addmod64(lo, hi, q);
                blk[s + d] = ntt_mulmod64(submod64(lo, hi, q), w, q);
            }
        }
    }
}

static void build_stage_table(u64* out, size_t n, u64 q, u64 base, u64 psi_b) {
    // p[t+j] = psi_b^(n/2t) * (base^(n/2t))^bitrev_t(j); psi_b=0 -> plain
    out[0] = 0;
    for (size_t t = 1; t < n; t <<= 1) {
        u64 g = ntt_powmod64(base, n / (2 * t), q);
        u64 pre = psi_b ? ntt_powmod64(psi_b, n / (2 * t), q) : 1;
        size_t bits = 0;
        while (((size_t)1 << bits) < t) bits++;
        for (size_t j = 0; j < t; j++) {
            size_t e = 0, x = j;
            for (size_t b = 0; b < bits; b++) { e = (e << 1) | (x & 1); x >>= 1; }
            out[t + j] = ntt_mulmod64(pre, ntt_powmod64(g, e, q), q);
        }
    }
}

// Full negacyclic (psi != 0) or cyclic (psi == 0) product, standard order
// in/out, canonical [0, q).  Scratch-free apart from two stage tables.
int ntt_polymul64(u64* c, const u64* a, const u64* b,
                  size_t n, u64 q, u64 psi) {
    if (n == 0 || (n & (n - 1))) return -1;
    u64 omega = psi ? ntt_mulmod64(psi, psi, q) : 0;
    if (!psi) return -2;                     // cyclic needs explicit omega
    u64* tw = new u64[2 * n];
    u64* fa = new u64[2 * n];
    u64* tw_inv = tw + n;
    u64* fb = fa + n;
    build_stage_table(tw, n, q, omega, psi);
    build_stage_table(tw_inv, n, q, ntt_invmod64(omega, q),
                      ntt_invmod64(psi, q));
    std::memcpy(fa, a, n * sizeof(u64));
    std::memcpy(fb, b, n * sizeof(u64));
    fwd_ct_std2rev(fa, n, q, tw);            // psi-merged: mulntt variant
    fwd_ct_std2rev(fb, n, q, tw);
    for (size_t i = 0; i < n; i++) c[i] = ntt_mulmod64(fa[i], fb[i], q);
    inv_gs_rev2std(c, n, q, tw_inv);         // psi^-1-merged
    u64 ninv = ntt_invmod64((u64)n % q, q);
    for (size_t i = 0; i < n; i++) c[i] = ntt_mulmod64(c[i], ninv, q);
    delete[] tw;
    delete[] fa;
    return 0;
}

// ---------------------------------------------------------------------------
// RNS split / Garner CRT reconstruction
// ---------------------------------------------------------------------------

// residues[k*n]: row i = a mod primes[i]
void ntt_rns_split(const u64* a, size_t n, const u64* primes, int k,
                   int32_t* residues) {
    for (int i = 0; i < k; i++) {
        u64 p = primes[i];
        int32_t* row = residues + (size_t)i * n;
        for (size_t j = 0; j < n; j++) row[j] = (int32_t)(a[j] % p);
    }
}

// Barrett reduction helpers for fixed moduli p < 2^30: one u128 multiply
// (cheap) instead of a u128 division (slow) per modular product.
struct Barrett {
    u64 p;
    u64 m;                                   // floor(2^64 / p)
    void init(u64 p_) { p = p_; m = (u64)(((u128)1 << 64) / p_); }
    // reduce z < 2^63: quotient estimate via mulhi, at most 2 corrections
    inline u64 red(u64 z) const {
        u64 qh = (u64)(((u128)z * m) >> 64);
        u64 r = z - qh * p;
        while (r >= p) r -= p;
        return r;
    }
};

// Garner mixed-radix CRT of k residue rows -> value mod q, with signed
// centering: the reconstructed integer x in [0, M) is interpreted in
// (-M/2, M/2] before reduction (negacyclic convolutions are signed).
// residues: k x n int32 (each in [0, p_i)); out: n x uint64 in [0, q).
void ntt_crt_garner(const int32_t* residues, int k, size_t n,
                    const u64* primes, u64 q, u64* out) {
    // precompute C_i = inv(p_0...p_{i-1}) mod p_i
    u64 Cinv[64];
    for (int i = 1; i < k; i++) {
        u64 prod = 1 % primes[i];
        for (int j = 0; j < i; j++)
            prod = ntt_mulmod64(prod, primes[j] % primes[i], primes[i]);
        Cinv[i] = ntt_invmod64(prod, primes[i]);
    }
    // mixed-radix digits of M/2 (for the signed-centering comparison):
    // M/2 = (p_0/...)— compute digits of (M-1)/2 via long division is
    // awkward; instead compare x against M/2 by reconstructing the digits
    // of M-1 (all p_i-1) and noting x > M/2 iff 2x > M iff 2x mod M < 2x
    // ... simplest robust test: reconstruct the top mixed-radix digit and
    // compare with p_{k-1}/2 (exact when k-th digit differs; ties broken
    // by lower digits — resolved below with full lexicographic compare).
    u64 half_digits[64];                    // mixed-radix digits of M/2
    {
        // M/2 in mixed radix: M = p0*p1*...*p_{k-1}; M/2 has digits of
        // (p0/2 rounded?) — compute by long division of M by 2 in mixed
        // radix from the top: M = sum d_i * P_i with P_i = p0..p_{i-1}.
        // M's representation is d_i = 0 for all i with d_k = 1 (overflow);
        // easier: compute M/2 digits by evaluating (M >> 1) mod p_chain
        // via simulated big division — done in O(k^2) with u128:
        // M/2 = (p0*p1*...*p_{k-1}) / 2: since all p_i odd, M odd,
        // floor(M/2) = (M-1)/2. Digits of (M-1)/2: (M-1)/2 =
        // sum_{i} ((p_i-1)/2) * P_i  ... verify: sum ((p_i-1)/2)*P_i
        //  = (1/2) sum (p_i-1) P_i = (1/2)(M - 1).  Telescoping: yes,
        // sum_{i}(p_i-1)P_i = M - 1.  So digit i of (M-1)/2 is (p_i-1)/2.
        for (int i = 0; i < k; i++) half_digits[i] = (primes[i] - 1) / 2;
    }
    // q-residues of the mixed-radix weights P_i = p_0...p_{i-1} mod q
    u64 Pq[64];
    Pq[0] = 1 % q;
    for (int i = 1; i < k; i++)
        Pq[i] = ntt_mulmod64(Pq[i - 1], primes[i - 1] % q, q);
    u64 Mq = ntt_mulmod64(Pq[k - 1], primes[k - 1] % q, q);  // M mod q

    // Barrett contexts per channel prime (all < 2^29)
    Barrett bar[64];
    for (int i = 0; i < k; i++) bar[i].init(primes[i]);

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (size_t j = 0; j < n; j++) {
        u64 v[64];
        // Garner digits — all arithmetic in Barrett-reduced small primes
        v[0] = bar[0].red((u64)residues[j]);
        for (int i = 1; i < k; i++) {
            const Barrett& B = bar[i];
            u64 p = B.p;
            // t = (((v_{i-1}·p_{i-2} + v_{i-2})·p_{i-3} + ...) mod p
            u64 t = B.red(v[i - 1]);
            for (int m = i - 2; m >= 0; m--)
                t = B.red(B.red(t * (primes[m] % p)) + v[m]);
            u64 ci = (u64)residues[(size_t)i * n + j];
            if (ci >= p) ci = B.red(ci);
            u64 d = ci >= t ? ci - t : ci + p - t;
            v[i] = B.red(d * Cinv[i]);            // d, Cinv < 2^29: z < 2^58
        }
        // signed centering: x > (M-1)/2  <=>  digits lexicographically
        // greater from the top
        bool negative = false;
        for (int i = k - 1; i >= 0; i--) {
            if (v[i] != half_digits[i]) {
                negative = v[i] > half_digits[i];
                break;
            }
        }
        // x mod q via the weight residues (u128 divisions, amortised:
        // accumulate the full sum in 128 bits, reduce once per two terms)
        u128 acc = 0;
        for (int i = 0; i < k; i++) {
            acc += (u128)v[i] * Pq[i];            // < 2^29+62 per term
            if ((i & 1) || i == k - 1) acc %= q;  // keep below 2^92
        }
        u64 x = (u64)acc;
        // subtract M mod q with no u64 overflow even for q close to
        // 2^64 (x + q would wrap): both branches stay below q
        if (negative) x = (x >= Mq) ? x - Mq : x + (q - Mq);
        out[j] = x;
    }
}

// ---------------------------------------------------------------------------
// schoolbook oracles (independent of the NTT path, for testing)
// ---------------------------------------------------------------------------

void ntt_schoolbook_negacyclic64(const u64* a, const u64* b, size_t n,
                                 u64 q, u64* c) {
    for (size_t kk = 0; kk < n; kk++) {
        u128 acc_pos = 0, acc_neg = 0;      // accumulate then reduce
        for (size_t i = 0; i <= kk; i++)
            acc_pos += (u128)(a[i] % q) * (b[kk - i] % q) % q;
        for (size_t i = kk + 1; i < n; i++)
            acc_neg += (u128)(a[i] % q) * (b[n + kk - i] % q) % q;
        u64 pos = (u64)(acc_pos % q), neg = (u64)(acc_neg % q);
        c[kk] = submod64(pos, neg, q);
    }
}

}  // extern "C"

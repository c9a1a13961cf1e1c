"""Large-modulus polynomial multiplication via RNS channels + CRT.

The reference claims parametric support up to K=64-bit coefficients
(``defines.v:42``) by making every datapath wire wider — viable in silicon,
not in the int32 arithmetic of ops/modmul.  This design instead computes the *integer* negacyclic convolution through several
NTT-friendly ~28-bit RNS channels — each one a fast int32 transform from
transform.py/parallel/sharded.py — and reconstructs mod the big q with a
signed Garner CRT (native __int128 code, csrc/nttcore.cpp), exactly the
structure of production RNS/FHE libraries.

Correctness: channel products equal the integer negacyclic product mod
p_i; with  Π p_i > 2·n·(q-1)²  the signed coefficients (range ±n·q²) are
recovered exactly, then reduced mod q.

Covers BASELINE config 4: single transforms n=2^16..2^20 with 62-bit
primes, single-host sharded (channels run through ShardedPlan when a mesh
is given).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .params import NTTParams, is_prime, make_params, stage_powers

__all__ = ["BigQPlan", "StackedChannelPlan", "DeviceCRT",
           "select_rns_primes"]


def select_rns_primes(n: int, min_product_bits: int,
                      limit: int = 1 << 29) -> list[int]:
    """NTT-friendly channel primes p ≡ 1 (mod 2n), p < 2^29 (MontArith
    range), largest first, until Π p exceeds 2^min_product_bits."""
    step = 2 * n
    p = (limit - 1) // step * step + 1
    out, bits = [], 0.0
    while p > step and bits < min_product_bits:
        if is_prime(p):
            out.append(p)
            bits += np.log2(p)
        p -= step
    if bits < min_product_bits:
        raise ValueError(
            f"not enough NTT-friendly channel primes for n={n}: "
            f"got {bits:.0f} of {min_product_bits} bits")
    return out


class StackedChannelPlan:
    """All RNS channels in ONE jitted graph.

    Per-channel 15-bit digit-serial Montgomery arithmetic vectorised over a
    leading channel axis: the moduli/constants become (k,1,1,1,1) arrays and
    every butterfly stage operates on a (k, B, blocks, 2, width) view — one
    compile, one h2d per operand, one d2h, instead of k sequential plans.
    Used for n <= 8192; larger rings go through per-channel four-step plans.
    """

    M15 = (1 << 15) - 1

    def __init__(self, n: int, primes: list[int]):
        self.n = n
        self.primes = [int(p) for p in primes]
        self.k = len(self.primes)
        self.plist = [make_params(n, p) for p in self.primes]
        self.log2n = self.plist[0].log2n
        R = 1 << 30

        def ch(vals):
            return np.array(vals, dtype=np.int64).astype(np.int32).reshape(
                self.k, 1, 1, 1, 1)

        self._q = ch(self.primes)
        self._q0 = ch([p & self.M15 for p in self.primes])
        self._q1 = ch([p >> 15 for p in self.primes])
        self._qp = ch([(-pow(p, -1, 1 << 15)) % (1 << 15)
                       for p in self.primes])
        # per-channel stage tables in Montgomery form (w·R mod p), stacked:
        # forward = psi-merged CT std2rev, inverse = psi^-1-merged GS rev2std
        def stacked(inverse):
            rows = []
            for p in self.plist:
                base = p.omega_inv if inverse else p.omega
                psi_b = p.psi_inv if inverse else p.psi
                flat = stage_powers(p, base, rev=True, psi_base=psi_b)
                rows.append(flat * R % p.q)
            return np.stack(rows).astype(np.int64).astype(np.int32)

        self._twf = stacked(False)            # (k, n)
        self._twi = stacked(True)
        self._final = ch([p.n_inv * R % p.q * R % p.q
                          for p in self.plist])  # n^-1·R² (cancels mul's R^-1)

    # -- vectorised per-channel Montgomery REDC (see ops/modmul.MontArith) --
    def _redc(self, H, Mid, L0):
        m = jnp.int32(self.M15)
        u0 = ((L0 & m) * self._qp) & m
        t1 = (L0 + u0 * self._q0) >> 15
        A1 = Mid + u0 * self._q1 + t1
        a1h, a1l = A1 >> 15, A1 & m
        u1 = (a1l * self._qp) & m
        t2 = (a1l + u1 * self._q0) >> 15
        res = H + a1h + u1 * self._q1 + t2
        res = res - self._q
        res = res + ((res >> 31) & self._q)
        res = res - self._q
        return res + ((res >> 31) & self._q)

    def _mul(self, x, y):
        m = jnp.int32(self.M15)
        x1, x0 = x >> 15, x & m
        y1, y0 = y >> 15, y & m
        return self._redc(x1 * y1, x1 * y0 + x0 * y1, x0 * y0)

    def _add(self, x, y):
        r = x + y - self._q
        return r + ((r >> 31) & self._q)

    def _sub(self, x, y):
        r = x - y
        return r + ((r >> 31) & self._q)

    def _stages(self, x, tw, kind):
        k, B = x.shape[0], x.shape[1]
        n = self.n
        for s in range(self.log2n):
            if kind == "ct":                  # std2rev: t blocks of width d
                t = 1 << s
                d = n // (2 * t)
                v = x.reshape(k, B, t, 2, d)
                w = tw[:, t:2 * t].reshape(k, 1, t, 1, 1)
            else:                             # gs rev2std: d-wide blocks
                d = 1 << s
                t = n // (2 * d)
                v = x.reshape(k, B, t, 2, d)
                w = tw[:, t:2 * t].reshape(k, 1, t, 1, 1)
            lo = v[:, :, :, 0, :][:, :, :, None, :]
            hi = v[:, :, :, 1, :][:, :, :, None, :]
            if kind == "ct":
                mm = self._mul(hi, w)
                nlo, nhi = self._add(lo, mm), self._sub(lo, mm)
            else:
                nlo = self._add(lo, hi)
                nhi = self._mul(self._sub(lo, hi), w)
            x = jnp.concatenate([nlo, nhi], axis=3).reshape(k, B, n)
        return x

    def _polymul(self, ra, rb):
        """(k, B, n) int32 residues -> (k, B, n) channel products."""
        fa = self._stages(ra, jnp.asarray(self._twf), "ct")
        fb = self._stages(rb, jnp.asarray(self._twf), "ct")
        c = self._mul(fa[:, :, None, None, :],
                      fb[:, :, None, None, :])[:, :, 0, 0, :]
        c = self._stages(c, jnp.asarray(self._twi), "gs")
        out = self._mul(c[:, :, None, None, :],
                        jnp.broadcast_to(self._final,
                                         (self.k, 1, 1, 1, 1)))
        return out[:, :, 0, 0, :]

    @functools.cached_property
    def polymul_jit(self):
        return jax.jit(self._polymul)


class DeviceCRT:
    """Device-side RNS split + Garner reconstruction + mod-q recombine.

    Keeps the whole big-q pipeline in one XLA graph: inputs/outputs cross
    the host boundary as two packed int32 planes per operand
    (ops/limb.pack_u64_planes) instead of k residue planes — the
    transfer-volume analog of the reference streaming packed words over
    its PCIe FIFOs rather than unpacked per-channel data.

    Split: value = c3·2^S3 + c2·2^S2 + c1·2^16 + c0 (16-bit chunks; the
    shifts follow the plane packing — (31, 47) legacy / (32, 48) for
    62 < bits(q) <= 64), so each channel residue is four Montgomery
    constant-multiplies.
    Garner: classic mixed-radix digits v_j with per-channel int32
    Montgomery arithmetic (O(k²) muls); the signed correction (values
    above (M-1)/2 represent negatives) is a lexicographic digit compare
    against (M-1)/2 and one extra (-M mod q) term.
    Recombine: S = Σ v_j·(C_j mod q) + neg·((-M) mod q) through the
    15-bit limb accumulator (ops/limb.LimbArith), exact for q < 2^64
    (the full K range the reference claims, defines.v:42).
    """

    def __init__(self, primes: list[int], q: int):
        from .ops.modmul import MontArith
        from .ops.limb import LimbArith
        if min(primes) <= (1 << 16):
            raise ValueError("DeviceCRT needs channel primes > 2^16")
        self.primes = [int(p) for p in primes]
        self.k = len(self.primes)
        self.q = q
        self.ars = [MontArith(p) for p in self.primes]
        self.limb = LimbArith(q)

        M = 1
        for p in self.primes:
            M *= p
        self.M = M
        # split constants: 2^shift mod p per 16-bit chunk, per channel —
        # shifts follow the plane packing (legacy lo31/hi31 for q < 2^62,
        # true 32-bit halves for the 62..64-bit range, limb.chunk_shifts)
        self._split_tabs = [
            [ar.const_table(np.array([pow(2, e, p)]))
             for e in self.limb.chunk_shifts]
            for p, ar in zip(self.primes, self.ars)]
        # Garner constants: C_i = prod_{l<i} p_l
        C = [1]
        for p in self.primes[:-1]:
            C.append(C[-1] * p)
        self._C = C
        self._c_mod_p = [
            [self.ars[j].const_table(np.array([C[i] % self.primes[j]]))
             for i in range(j)]
            for j in range(self.k)]
        self._invC = [
            self.ars[j].const_table(
                np.array([pow(C[j] % self.primes[j], -1, self.primes[j])]))
            for j in range(self.k)]
        # mixed-radix digits of (M-1)/2 (host ints)
        half = (M - 1) // 2
        self._half_digits = []
        for p in self.primes:
            self._half_digits.append(half % p)
            half //= p
        self._negM = (-M) % q

    # ------------------------------------------------------------------

    def split(self, lo, hi):
        """(lo31, hi31) int32 planes -> (k, ...) channel residues."""
        c0, c1, c2, c3 = self.limb.planes_to_16bit(lo, hi)
        out = []
        for ar, (t16, t31, t47) in zip(self.ars, self._split_tabs):
            r = ar.add(ar.mul_const(c3, t47), ar.mul_const(c2, t31))
            r = ar.add(r, ar.mul_const(c1, t16))
            out.append(ar.add(r, ar.correct(c0)))
        return jnp.stack(out)

    def reconstruct(self, prods):
        """(k, ...) canonical channel values -> (lo31, hi31) planes of
        the signed-CRT value mod q."""
        v = []
        for j in range(self.k):
            ar = self.ars[j]
            t = prods[j]
            acc = None
            for i in range(j):
                term = ar.mul_const(v[i], self._c_mod_p[j][i])
                acc = term if acc is None else ar.add(acc, term)
            if acc is not None:
                t = ar.sub(t, acc)
            v.append(ar.mul_const(t, self._invC[j]))

        # negative iff X > (M-1)/2: lexicographic mixed-radix compare
        gt = jnp.zeros(v[0].shape, bool)
        eq = jnp.ones(v[0].shape, bool)
        for j in reversed(range(self.k)):
            d = jnp.int32(self._half_digits[j])
            gt = gt | (eq & (v[j] > d))
            eq = eq & (v[j] == d)
        ind = gt.astype(jnp.int32)

        n_terms = 2 * self.k + 1
        acc = self.limb.zero_acc(v[0].shape, self.limb.L + 2)
        m15 = jnp.int32((1 << 15) - 1)
        for j in range(self.k):
            cj = self._C[j] % self.q
            self.limb.acc_mul_const(acc, v[j] & m15, cj)
            self.limb.acc_mul_const(acc, v[j] >> 15, (cj << 15) % self.q)
        self.limb.acc_mul_const(acc, ind, self._negM)
        limbs = self.limb.finalize(acc, n_terms)
        return self.limb.limbs_to_planes(limbs)


class BigQPlan:
    """Polynomial products in Z_q[x]/(x^n+1) for big q (q < 2^64).

    API: ``polymul(a, b)`` on (batch, n) uint64 host arrays.  Operands
    cross to the device as two packed int32 planes; the RNS split, the
    channel transforms and the Garner reconstruction run there in one XLA
    graph (:class:`DeviceCRT`).  Channels run stacked in one graph for
    n <= 8192 (:class:`StackedChannelPlan`) and as four-step
    :class:`~tpu_ntt.parallel.sharded.ShardedPlan` s past that, on a
    one-device mesh or sharded over ``mesh``.
    """

    def __init__(self, params: NTTParams, mesh=None, primes=None):
        if params.q.bit_length() > 64:
            raise ValueError("q must fit in 64 bits (defines.v:42 K<=64)")
        self.params = params
        n, q = params.n, params.q
        self.wide = q.bit_length() > 62   # true-32-bit plane packing
        # signed-Garner headroom: the integer negacyclic product has
        # coefficients in (-n·(q-1)², n·(q-1)²]; exact signed CRT needs
        # M > 2·n·(q-1)², i.e. 1 + log2n + 2·bits(q) bits (+1 margin) —
        # the derivation scales to 64-bit q unchanged, it just buys one
        # more ~29-bit channel
        need = 1 + params.log2n + 2 * q.bit_length() + 1
        self.primes = list(primes) if primes else select_rns_primes(n, need)
        self.M = 1
        for p in self.primes:
            self.M *= p
        assert self.M > 2 * n * (q - 1) ** 2
        # large flat stage-by-stage graphs compile slowly; past 8192
        # points the channels go four-step on a one-device mesh
        if mesh is None and n > 8192:
            from .parallel.sharded import make_mesh
            mesh = make_mesh(1)
        self.mesh = mesh
        # device-side split/CRT: only two packed planes per operand
        # cross the host link instead of k residue planes
        self.dcrt = (DeviceCRT(self.primes, q)
                     if min(self.primes) > (1 << 16) else None)
        if mesh is None:
            # all channels in one jitted graph: one transfer each way,
            # one compile, instead of k sequential plans
            self.stacked = StackedChannelPlan(n, self.primes)
            self.channel_plans = []
        else:
            from .parallel.sharded import ShardedPlan, mesh_axes
            axis, _ = mesh_axes(mesh)
            self.stacked = None
            self.channel_plans = [ShardedPlan(make_params(n, p), mesh,
                                              axis=axis)
                                  for p in self.primes]

    # ------------------------------------------------------------------

    @functools.cached_property
    def _native(self):
        from .runtime.native import load
        return load()

    def _split(self, a: np.ndarray) -> np.ndarray:
        """(B, n) uint64 -> (k, B, n) int32 residues."""
        flat = np.ascontiguousarray(a, dtype=np.uint64).reshape(-1)
        if self._native is not None:
            res = self._native.rns_split(flat, self.primes)
        else:
            res = np.stack([(flat % np.uint64(p)).astype(np.int32)
                            for p in self.primes])
        return res.reshape(len(self.primes), *a.shape)

    def _reconstruct(self, residues: np.ndarray) -> np.ndarray:
        """(k, B, n) int32 channel products -> (B, n) uint64 mod q."""
        k = len(self.primes)
        flat = np.ascontiguousarray(residues, dtype=np.int32).reshape(k, -1)
        if self._native is not None:
            out = self._native.crt_garner(flat, self.primes, self.params.q)
        else:
            out = self._crt_python(flat)
        return out.reshape(residues.shape[1:])

    def _crt_python(self, flat: np.ndarray) -> np.ndarray:
        """Slow exact fallback (python ints)."""
        q, M = self.params.q, self.M
        coeffs = []
        for p in self.primes:
            Mi = M // p
            coeffs.append((Mi, pow(Mi, -1, p)))
        out = np.zeros(flat.shape[1], dtype=np.uint64)
        for j in range(flat.shape[1]):
            x = 0
            for i, p in enumerate(self.primes):
                Mi, MiInv = coeffs[i]
                x += Mi * (int(flat[i, j]) * MiInv % p)
            x %= M
            if x > (M - 1) // 2:
                x -= M
            out[j] = x % q
        return out

    # ------------------------------------------------------------------

    @functools.cached_property
    def _fused_jit(self):
        """One XLA graph: device split -> channel products -> device
        Garner -> packed mod-q planes."""
        dcrt, stacked = self.dcrt, self.stacked

        def fused(lo_a, hi_a, lo_b, hi_b):
            ra = dcrt.split(lo_a, hi_a)
            rb = dcrt.split(lo_b, hi_b)
            return dcrt.reconstruct(stacked._polymul(ra, rb))

        return jax.jit(fused)

    @functools.cached_property
    def _fused_sharded_jit(self):
        """Mesh path, still ONE graph: split/Garner are elementwise so
        they run inside the same shard_map as every channel's four-step
        body; only packed planes cross the host link."""
        dcrt, plans = self.dcrt, self.channel_plans
        sp0 = plans[0]

        def body(lo_a, hi_a, lo_b, hi_b):
            ra = dcrt.split(lo_a, hi_a)          # (k, B, n1, L2) local
            rb = dcrt.split(lo_b, hi_b)
            outs = [plans[i]._polymul_body(ra[i], rb[i])
                    for i in range(len(plans))]
            return dcrt.reconstruct(jnp.stack(outs))

        spec = sp0.coef_spec
        return jax.jit(jax.shard_map(
            body, mesh=sp0.mesh, in_specs=(spec,) * 4,
            out_specs=(spec, spec), check_vma=False))

    def _sharded_planes(self, planes):
        from jax.sharding import NamedSharding
        sp0 = self.channel_plans[0]
        sh = NamedSharding(sp0.mesh, sp0.coef_spec)
        return tuple(jax.device_put(
            p.reshape(-1, sp0.n1, sp0.n2), sh) for p in planes)

    def device_planes(self, a):
        """(batch, n) uint64 host array -> its two packed int32 planes
        on the device, laid out as :meth:`polymul_planes` takes them."""
        from .ops.limb import pack_u64_planes
        planes = pack_u64_planes(np.atleast_2d(np.asarray(a, np.uint64)),
                                 wide=self.wide)
        if self.stacked is None:
            return self._sharded_planes(planes)
        return tuple(jax.device_put(p) for p in planes)

    def polymul_planes(self, lo_a, hi_a, lo_b, hi_b):
        """Device-resident product: packed planes in, packed planes of
        the product mod q out (one XLA dispatch).  Needs channel primes
        above 2^16 (the device Garner)."""
        fn = (self._fused_jit if self.stacked is not None
              else self._fused_sharded_jit)
        return fn(lo_a, hi_a, lo_b, hi_b)

    def polymul(self, a, b) -> np.ndarray:
        """Negacyclic product of (batch, n) uint64 arrays, mod big q."""
        from .validation import check_domain
        check_domain(a, self.params.q, "bigq polymul a")
        check_domain(b, self.params.q, "bigq polymul b")
        a = np.atleast_2d(np.asarray(a, dtype=np.uint64))
        b = np.atleast_2d(np.asarray(b, dtype=np.uint64))
        if self.dcrt is not None:
            from .ops.limb import unpack_u64_planes
            lo_c, hi_c = self.polymul_planes(*self.device_planes(a),
                                             *self.device_planes(b))
            return unpack_u64_planes(
                np.asarray(lo_c), np.asarray(hi_c),
                wide=self.wide).reshape(a.shape)
        ra, rb = self._split(a), self._split(b)
        if self.stacked is not None:
            prods = np.asarray(self.stacked.polymul_jit(ra, rb))
            return self._reconstruct(prods)
        outs = []
        for i, plan in enumerate(self.channel_plans):
            ci = plan.unshard(plan.polymul_jit(
                plan.shard_coeffs(ra[i]), plan.shard_coeffs(rb[i])))
            outs.append(ci.astype(np.int32))
        return self._reconstruct(np.stack(outs))

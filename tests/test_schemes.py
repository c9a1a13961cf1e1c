"""Incomplete-NTT (Kyber-style) tests."""

import numpy as np
import pytest

from tpu_ntt import ref
from tpu_ntt.schemes import IncompletePlan, auto_plan, kyber_plan
from tpu_ntt.transform import Plan


def test_kyber_point(rng):
    """The real ML-KEM ring: n=256, q=3329 (no 512th root exists)."""
    kp = kyber_plan()
    assert kp.m == 128 and kp.levels == 1
    a = rng.integers(0, 3329, (4, 256)).astype(np.int32)
    b = rng.integers(0, 3329, (4, 256)).astype(np.int32)
    c = np.asarray(kp.polymul_jit(a, b))
    for i in range(4):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], 3329))


def test_deeper_truncation(rng):
    ip = IncompletePlan(256, 3329, levels=2)
    assert ip.m == 64
    a = rng.integers(0, 3329, (2, 256)).astype(np.int32)
    b = rng.integers(0, 3329, (2, 256)).astype(np.int32)
    c = np.asarray(ip.polymul_jit(a, b))
    np.testing.assert_array_equal(
        c[0], ref.schoolbook_negacyclic(a[0], b[0], 3329))


def test_incomplete_with_montgomery(rng):
    """q=995329 (2-power part 2^12) at n=4096 forces one missing level in
    fix-free float-Barrett territory (2^15 <= q < 2^23)."""
    ip = IncompletePlan(4096, 995329)
    assert ip.levels == 1 and type(ip.arith).__name__ == "FBarrettArith"
    a = rng.integers(0, 995329, (1, 4096)).astype(np.int32)
    b = rng.integers(0, 995329, (1, 4096)).astype(np.int32)
    c = np.asarray(ip.polymul_jit(a, b))
    np.testing.assert_array_equal(
        c[0], ref.schoolbook_negacyclic(a[0], b[0], 995329))


def test_auto_plan_dispatch():
    assert isinstance(auto_plan(256, 3329), IncompletePlan)
    assert isinstance(auto_plan(256, 12289), Plan)


def test_unsupportable_depth():
    with pytest.raises(ValueError):
        IncompletePlan(256, 3329, levels=8)   # sub-size 1 is meaningless


def test_basemul_identity(rng):
    """Multiplying by the constant polynomial 1 is the identity."""
    kp = kyber_plan()
    a = rng.integers(0, 3329, (2, 256)).astype(np.int32)
    one = np.zeros((2, 256), dtype=np.int32)
    one[:, 0] = 1
    c = np.asarray(kp.polymul_jit(a, one))
    np.testing.assert_array_equal(c, a)


def _matvec_oracle(A, s, q):
    """Independent module-product oracle: schoolbook negacyclic products
    accumulated with plain modular adds."""
    r, c, n = A.shape
    out = np.zeros((r, n), dtype=np.int64)
    for i in range(r):
        for j in range(c):
            out[i] = (out[i]
                      + ref.schoolbook_negacyclic(A[i, j], s[j], q)) % q
    return out


def test_kyber_matvec(rng):
    """ML-KEM k=3 module product A_hat*s_hat through the spectral API."""
    kp = kyber_plan()
    A = rng.integers(0, 3329, (3, 3, 256)).astype(np.int32)
    s = rng.integers(0, 3329, (3, 256)).astype(np.int32)
    got = np.asarray(kp.matvec_jit(A, s))
    np.testing.assert_array_equal(got, _matvec_oracle(A, s, 3329))


def test_plan_matvec(rng):
    """Full-NTT matvec (Dilithium-style module) vs the same oracle."""
    from tpu_ntt.params import preset
    p = preset("sw256")
    plan = Plan(p)
    A = rng.integers(0, p.q, (2, 4, 2, 256)).astype(np.int32)
    s = rng.integers(0, p.q, (2, 2, 256)).astype(np.int32)
    got = np.asarray(plan.matvec_jit(A, s))
    assert got.shape == (2, 4, 256)
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], _matvec_oracle(A[b], s[b], p.q))


def test_matvec_shape_mismatch():
    kp = kyber_plan()
    with pytest.raises(ValueError):
        kp.matvec(np.zeros((2, 3, 256), np.int32),
                  np.zeros((2, 256), np.int32))


def test_fast_dispatch_forced_pallas(rng):
    """backend='pallas' demands the fused kernel: without a GPU it raises
    instead of silently running the interpreter.  The kernel itself (in
    interpret mode, as the tests run it) is the plan's bit-exact twin on
    the public polymul/matvec surface."""
    from tpu_ntt.ops.fused import FusedPolymul
    with pytest.raises(RuntimeError, match="GPU"):
        kyber_plan(backend="pallas")
    fast = FusedPolymul(kyber_plan(backend="xla"), interpret=True)
    a = rng.integers(0, 3329, (2, 256)).astype(np.int32)
    b = rng.integers(0, 3329, (2, 256)).astype(np.int32)
    c = np.asarray(fast.polymul(a, b))
    for i in range(2):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], 3329))
    np.testing.assert_array_equal(np.asarray(fast.polymul_jit(a, b)), c)
    A = rng.integers(0, 3329, (2, 2, 256)).astype(np.int32)
    s = rng.integers(0, 3329, (2, 256)).astype(np.int32)
    got = np.asarray(fast.matvec(A, s))
    np.testing.assert_array_equal(got, _matvec_oracle(A, s, 3329))


def test_fast_dispatch_auto_cpu_stays_xla():
    """Under backend='auto' on CPU the XLA plan serves (the fused kernel
    lowers only for GPUs); on a GPU the kernel wraps it — pinned
    on-device by test_gpu_parity.py."""
    assert type(kyber_plan()) is IncompletePlan
    assert type(kyber_plan(backend="xla")) is IncompletePlan


def test_explicit_xla_backend_never_accelerated():
    """backend='xla' is a contract: neither the plan nor the engine may
    silently re-dispatch to the fused kernel (r4 review finding)."""
    from tpu_ntt.runtime.engine import PolyMultEngine
    from tpu_ntt.dispatch import select_plan
    assert select_plan(256, 3329, backend="xla",
                       platform="gpu") == "incomplete"
    assert type(kyber_plan(backend="xla")) is IncompletePlan
    eng = PolyMultEngine(256, 3329, backend="xla")
    assert eng.kind == "incomplete"
    assert type(eng.plan) is IncompletePlan


def test_forced_pallas_matvec_jit(rng):
    """The kernel's matvec_jit compiles the whole module product (kernel
    transforms around the XLA multiply-accumulate) as one graph, for a
    square and a wide (c = 5) matrix."""
    from tpu_ntt.ops.fused import FusedPolymul
    fast = FusedPolymul(kyber_plan(backend="xla"), interpret=True)
    A = rng.integers(0, 3329, (2, 2, 256)).astype(np.int32)
    s = rng.integers(0, 3329, (2, 256)).astype(np.int32)
    got = np.asarray(fast.matvec_jit(A, s))
    np.testing.assert_array_equal(got, _matvec_oracle(A, s, 3329))
    A5 = rng.integers(0, 3329, (1, 5, 256)).astype(np.int32)
    s5 = rng.integers(0, 3329, (5, 256)).astype(np.int32)
    got5 = np.asarray(fast.matvec_jit(A5, s5))
    np.testing.assert_array_equal(got5, _matvec_oracle(A5, s5, 3329))


def test_natural_l2_parameter_point(rng):
    """A q whose 2-power part forces levels=2 NATURALLY (q=2689,
    q-1 = 2^7·21: an order-128 root exists, no 256th) — the L>=2 menu
    point VERDICT r3 asked to pin (task 8); auto level selection must
    land on 2 and the degree-3 base case must be exact."""
    ip = IncompletePlan(256, 2689)
    assert ip.levels == 2 and ip.m == 64
    a = rng.integers(0, 2689, (2, 256)).astype(np.int32)
    b = rng.integers(0, 2689, (2, 256)).astype(np.int32)
    c = np.asarray(ip.polymul_jit(a, b))
    for i in range(2):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], 2689))


def test_fast_matvec_envelope_fallback(rng):
    """The fused matvec has no shape envelope: a wide (r=1, c=5) product
    is exact through the kernel and through the plan's XLA matvec."""
    from tpu_ntt.ops.fused import FusedPolymul
    kp = kyber_plan(backend="xla")
    A = rng.integers(0, 3329, (1, 5, 256)).astype(np.int32)
    s = rng.integers(0, 3329, (5, 256)).astype(np.int32)
    want = _matvec_oracle(A, s, 3329)
    np.testing.assert_array_equal(np.asarray(kp.matvec(A, s)), want)
    fast = FusedPolymul(kp, interpret=True)
    np.testing.assert_array_equal(np.asarray(fast.matvec(A, s)), want)

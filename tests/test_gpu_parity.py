"""On-device parity suite — the real-hardware testbench discipline of the
reference (NTT_PolyMul_test.v:165-226, NTTN_test.v:47-56 run golden vectors
against the actual board; here the golden vectors, the compiled-C parity
products, and kernel-vs-oracle equality run through the compiled fused
kernel and the XLA plans on a GPU).

Run on a machine with a GPU with::

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

Every test here is marked ``gpu`` and takes the ``gpu`` fixture, which
skips it when JAX's default backend is not a GPU.
"""

import numpy as np
import pytest

from tpu_ntt import ref
from tpu_ntt.params import find_params, make_params, preset

from conftest import read_hex_vectors
from test_parity_c import build_c_oracle, _call_product

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


def _sparse_poly(rng, n, q, nnz=6):
    """Random polynomial with few nonzero terms (exact big-int oracle
    tractable at any n)."""
    a = np.zeros(n, dtype=np.int64)
    idx = rng.choice(n, size=nnz, replace=False)
    a[idx] = rng.integers(1, q, size=nnz)
    return a


def _sparse_negacyclic(a, b, q):
    """Exact negacyclic product of sparse polynomials via python ints."""
    n = len(a)
    out = [0] * n
    for i in np.flatnonzero(a):
        ai = int(a[i])
        for j in np.flatnonzero(b):
            k = i + int(j)
            t = ai * int(b[j])
            if k >= n:
                out[k - n] -= t
            else:
                out[k] += t
    return np.array([v % q for v in out], dtype=np.uint64)


# ---------------------------------------------------------------------------
# golden ModelSim vectors through the device (NTTN_test.v analog)
# ---------------------------------------------------------------------------

def test_golden_vectors_on_device(reference_dir):
    import jax
    from tpu_ntt.transform import Plan
    base = reference_dir / "Hardware_Multiplier/simulation/modelsim/test"
    din = read_hex_vectors(base / "NTT_DIN.txt")
    dout = read_hex_vectors(base / "NTT_DOUT.txt")
    idin = read_hex_vectors(base / "INTT_DIN.txt")
    idout = read_hex_vectors(base / "INTT_DOUT.txt")
    p = preset("hw256")
    plan = Plan(p)
    fwd = jax.jit(lambda x: plan.ntt(x, "gs", "std2rev"))
    got = np.asarray(fwd(din[None].astype(np.int32)))[0]
    np.testing.assert_array_equal(got, dout)
    inv = jax.jit(lambda x: plan.ntt(x, "gs", "std2rev", inverse=True))
    got_i = np.asarray(inv(idin[None].astype(np.int32)))[0]
    got_i = got_i.astype(np.int64) * p.n_inv % p.q
    np.testing.assert_array_equal(got_i, idout)


def test_rtl_testbench_product_on_device():
    """(1+2x+3x^2)(2+2x) through the device GO-flow twin
    (NTT_PolyMul_test.v:165-196)."""
    import jax
    from tpu_ntt.transform import Plan
    p = preset("hw256")
    plan = Plan(p)
    a = np.zeros((1, p.n), np.int32)
    b = np.zeros((1, p.n), np.int32)
    a[0, :3] = [1, 2, 3]
    b[0, :2] = [2, 2]
    c = np.asarray(jax.jit(plan.hw_polymul)(a, b))[0]
    want = np.zeros(p.n, np.int64)
    want[:4] = [2, 6, 10, 6]
    np.testing.assert_array_equal(c, want)


# ---------------------------------------------------------------------------
# compiled-C parity through the real fused kernels
# ---------------------------------------------------------------------------

def test_c_parity_through_fused_kernel(reference_dir, rng):
    """ntt_red256_product1/4 bit-exact vs the compiled fused kernel."""
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.transform import Plan
    lib = build_c_oracle(reference_dir)
    p = preset("sw256")
    pk = FusedPolymul(Plan(p))
    rows = 16
    a = rng.integers(0, p.q, (rows, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (rows, p.n)).astype(np.int32)
    got = np.asarray(pk.polymul(a, b))
    for i in range(rows):
        for cname in ("ntt_red256_product1", "ntt_red256_product4"):
            want = _call_product(lib, cname, a[i], b[i])
            np.testing.assert_array_equal(got[i], want)


# ---------------------------------------------------------------------------
# kernel-vs-oracle equality per arithmetic flavor, on the real chip
# ---------------------------------------------------------------------------

FLAVOR_CASES = [
    ("sw256", None, None),            # Shoup, q < 2^15
    ("hw256", None, None),            # Shoup, second modulus
    ("dilithium256", None, None),     # float-assisted Barrett, q < 2^23
    (None, 256, 28),                  # digit-serial Montgomery, q < 2^29
]


@pytest.mark.parametrize("name,n,bits", FLAVOR_CASES)
def test_fused_kernel_on_device(rng, name, n, bits):
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.transform import Plan
    p = preset(name) if name else find_params(n, bits)
    plan = Plan(p)
    pk = FusedPolymul(plan)
    rows = 16
    a = rng.integers(0, p.q, (rows, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (rows, p.n)).astype(np.int32)
    a[0] = p.q - 1                      # range extremes
    b[0] = p.q - 1
    got = np.asarray(pk.polymul(a, b))
    for i in range(rows):
        np.testing.assert_array_equal(
            got[i], ref.schoolbook_negacyclic(a[i], b[i], p.q))
    # standalone transforms: kernel == XLA Plan, both on the device
    f_kernel = np.asarray(pk.forward(a))
    f_plan = np.asarray(plan.forward_jit(a))
    np.testing.assert_array_equal(f_kernel, f_plan)
    np.testing.assert_array_equal(np.asarray(pk.inverse(f_kernel)),
                                  np.asarray(plan.inverse_jit(f_plan)))


def test_incomplete_kyber_on_device(rng):
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.schemes import IncompletePlan
    n, q = 256, 3329
    pk = FusedPolymul(IncompletePlan(n, q, levels=1))
    rows = 16
    a = rng.integers(0, q, (rows, n)).astype(np.int32)
    b = rng.integers(0, q, (rows, n)).astype(np.int32)
    got = np.asarray(pk.polymul(a, b))
    for i in range(rows):
        np.testing.assert_array_equal(
            got[i], ref.schoolbook_negacyclic(a[i], b[i], q))
    # module product A_hat · s_hat (the ML-KEM matvec fast path)
    k = 3
    A = rng.integers(0, q, (2, k, k, n)).astype(np.int32)
    s = rng.integers(0, q, (2, k, n)).astype(np.int32)
    mv = np.asarray(pk.matvec(A, s))
    for r in range(2):
        for i in range(k):
            want = np.zeros(n, dtype=np.int64)
            for j in range(k):
                want = (want + ref.schoolbook_negacyclic(
                    A[r, i, j], s[r, j], q)) % q
            np.testing.assert_array_equal(mv[r, i].astype(np.int64), want)


def test_auto_dispatch_reaches_fused_kernel_on_device(rng):
    """On a GPU the PUBLIC entry points — PolyMultEngine(backend='auto'),
    kyber_plan(), auto_plan() — reach the fused kernel (the reference
    mode FSM always reaches the PE array, PolyMult.v:110-124), and the
    kernel's matvec equals the XLA IncompletePlan's."""
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.runtime.engine import PolyMultEngine
    from tpu_ntt.schemes import auto_plan, kyber_plan
    eng = PolyMultEngine(256, 3329)           # backend="auto"
    assert eng.kind == "fused-incomplete"
    kp = kyber_plan()
    assert isinstance(kp, FusedPolymul)
    assert isinstance(auto_plan(256, 3329), FusedPolymul)
    assert isinstance(auto_plan(256, 12289), FusedPolymul)
    a = rng.integers(0, 3329, (4, 256)).astype(np.int32)
    b = rng.integers(0, 3329, (4, 256)).astype(np.int32)
    c = np.asarray(kp.polymul(a, b))
    ce = eng.multiply(a, b)
    for i in range(4):
        want = ref.schoolbook_negacyclic(a[i], b[i], 3329)
        np.testing.assert_array_equal(c[i], want)
        np.testing.assert_array_equal(ce[i], want)
    # public matvec runs the kernel's transforms
    k = 3
    A = rng.integers(0, 3329, (2, k, k, 256)).astype(np.int32)
    s = rng.integers(0, 3329, (2, k, 256)).astype(np.int32)
    got = np.asarray(kp.matvec(A, s))
    want = np.asarray(kp.plan.matvec(A, s))
    np.testing.assert_array_equal(got, want)


def test_cyclic_fused_dispatch_on_device(rng):
    """The HARDWARE's own product semantics — the cyclic ring
    (PolyMult.v:176-238, no psi twist) — dispatches to the fused kernel
    through the public Ring/engine surface, bit-exact vs both the
    schoolbook and the GO-flow twin hw_polymul."""
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.ring import Ring
    R = Ring(256, 7681, negacyclic=False)
    assert R._engine.kind == "fused", R._engine.kind
    assert isinstance(R._engine.plan, FusedPolymul)
    a = rng.integers(0, 7681, (4, 256)).astype(np.int64)
    b = rng.integers(0, 7681, (4, 256)).astype(np.int64)
    c = R.mul(a, b)
    p = make_params(256, 7681, negacyclic=False)
    for i in range(4):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_cyclic(a[i], b[i], 7681))
        np.testing.assert_array_equal(
            c[i].astype(np.int64), ref.hw_polymul(a[i], b[i], p))


def test_incomplete_l2_on_device(rng):
    """L=2 incomplete point (q=2689: order-128 root only) on the card —
    the XLA IncompletePlan (the fused kernel covers L=1 only)."""
    from tpu_ntt.schemes import IncompletePlan
    ip = IncompletePlan(256, 2689)
    assert ip.levels == 2
    a = rng.integers(0, 2689, (4, 256)).astype(np.int32)
    b = rng.integers(0, 2689, (4, 256)).astype(np.int32)
    c = np.asarray(ip.polymul_jit(a, b))
    for i in range(4):
        np.testing.assert_array_equal(
            c[i], ref.schoolbook_negacyclic(a[i], b[i], 2689))


def test_fourstep_large_on_device(rng):
    """n=2^16 four-step plan on a one-device mesh vs the exact sparse
    oracle — the large-ring datapath (NTTN.v:25-27 scales to 2^15; here
    2^16)."""
    from tpu_ntt.runtime.engine import PolyMultEngine
    p = find_params(1 << 16, 28)
    eng = PolyMultEngine(p.n, p.q)
    assert eng.kind == "fourstep"
    rows = 4
    a = np.stack([_sparse_poly(rng, p.n, p.q) for _ in range(rows)])
    b = np.stack([_sparse_poly(rng, p.n, p.q) for _ in range(rows)])
    got = eng.multiply(a, b)
    for i in range(rows):
        want = _sparse_negacyclic(a[i], b[i], p.q)
        np.testing.assert_array_equal(got[i].astype(np.uint64), want)


def test_bigq62_on_device(rng):
    """62-bit modulus RNS pipeline (device split -> stacked channel
    transforms -> device Garner CRT) vs the exact sparse oracle."""
    from tpu_ntt.bigq import BigQPlan
    p = find_params(4096, 62)
    plan = BigQPlan(p)
    rows = 4
    a = np.stack([_sparse_poly(rng, p.n, p.q) for _ in range(rows)])
    b = np.stack([_sparse_poly(rng, p.n, p.q) for _ in range(rows)])
    got = plan.polymul(a.astype(np.uint64), b.astype(np.uint64))
    for i in range(rows):
        want = _sparse_negacyclic(a[i], b[i], p.q)
        np.testing.assert_array_equal(got[i], want)


def test_staged_session_on_device(rng):
    """The v1 address-mapped-protocol analog on the card: fixed shape,
    compile-at-construction, reusable (not donated) buffers — bit-exact
    with the engine, and the dispatch-overhead comparison runs."""
    from tpu_ntt.runtime.engine import PolyMultEngine
    from tpu_ntt.runtime.staged import StagedSession
    eng = PolyMultEngine(256, 12289)
    sess = StagedSession(eng, batch=64)
    a = rng.integers(0, 12289, (64, 256))
    b = rng.integers(0, 12289, (64, 256))
    got = sess.multiply(a, b)
    np.testing.assert_array_equal(got, eng.multiply(a, b))
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], ref.schoolbook_negacyclic(a[i], b[i], 12289))
    d = sess.measure_overhead(iters=20)
    assert d["staged_us"] > 0 and d["engine_us"] > 0


def test_bigq64_goldilocks_on_device(rng):
    """A full 64-bit NTT prime (goldilocks 2^64-2^32+1 — the top of the
    reference's K<=64 claim, defines.v:42) through the big-q pipeline on
    the card, wide (true-32-bit-halves) plane packing, vs the exact sparse
    oracle."""
    from tpu_ntt.bigq import BigQPlan
    q = 0xFFFFFFFF00000001
    p = make_params(4096, q)
    plan = BigQPlan(p)
    assert plan.wide
    rows = 4
    a = np.zeros((rows, p.n), dtype=np.uint64)
    b = np.zeros((rows, p.n), dtype=np.uint64)
    for r in range(rows):
        ia = rng.choice(p.n, size=6, replace=False)
        ib = rng.choice(p.n, size=6, replace=False)
        a[r, ia] = rng.integers(1, q, size=6, dtype=np.uint64)
        b[r, ib] = rng.integers(1, q, size=6, dtype=np.uint64)
    a[0, 0] = q - 1
    b[0, 0] = q - 1                      # worst-case signed magnitude
    got = plan.polymul(a, b)
    for i in range(rows):
        want = _sparse_negacyclic(a[i], b[i], q)
        np.testing.assert_array_equal(got[i], want)


def test_engine_selftest_on_device():
    """The progressive bring-up ladder (v3/v4 loopback analog) passes on
    the card with the auto (fused kernel) backend."""
    from tpu_ntt.runtime.engine import PolyMultEngine
    eng = PolyMultEngine(256, 12289)
    rep = eng.self_test()
    assert rep.ok, str(rep)


def test_bigq_large_n_on_device(rng):
    """BASELINE config 4 evidence: n=2^16 62-bit big-q through device
    split -> per-channel four-step plans -> device Garner, vs the exact
    sparse oracle on the card."""
    from tpu_ntt.bigq import BigQPlan
    p = find_params(1 << 16, 62)
    plan = BigQPlan(p)
    assert plan.channel_plans and plan.dcrt is not None
    rows = 2
    a = np.stack([_sparse_poly(rng, p.n, p.q) for _ in range(rows)])
    b = np.stack([_sparse_poly(rng, p.n, p.q) for _ in range(rows)])
    got = plan.polymul(a.astype(np.uint64), b.astype(np.uint64))
    for i in range(rows):
        want = _sparse_negacyclic(a[i], b[i], p.q)
        np.testing.assert_array_equal(got[i], want)


def test_sharded_one_chip_mesh_on_device(rng):
    """ShardedPlan on a one-device mesh (D=1 degenerate four-step: the
    collective schedule with no peers) matches the single-device plan
    bit-exactly on the card."""
    from tpu_ntt.parallel.sharded import ShardedPlan, make_mesh
    from tpu_ntt.transform import Plan
    p = make_params(4096, 12289)
    sp = ShardedPlan(p, make_mesh(1))
    plan = Plan(p)
    a = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (2, p.n)).astype(np.int32)
    got = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a),
                                    sp.shard_coeffs(b)))
    want = np.asarray(plan.polymul_jit(a, b))
    np.testing.assert_array_equal(got, want)


def test_engine_crossover_dispatch_on_device(rng):
    """The engine's backend hand-off points execute correctly on the
    card: the fused kernel at n=1024, the flat XLA plan at n=8192,
    four-step past it — each vs the exact sparse oracle."""
    from tpu_ntt.runtime.engine import PolyMultEngine

    cases = [
        (1024, find_params(1024, 27).q, "fused"),
        (8192, find_params(8192, 27).q, "xla"),
        (16384, find_params(16384, 27).q, "fourstep"),
    ]
    for n, q, want_kind in cases:
        eng = PolyMultEngine(n, q)
        assert eng.kind == want_kind, (n, eng.kind)
        a = _sparse_poly(rng, n, q)
        b = _sparse_poly(rng, n, q)
        got = np.asarray(eng.multiply(a[None].astype(np.int64),
                                      b[None].astype(np.int64)))[0]
        want = _sparse_negacyclic(a, b, q)
        np.testing.assert_array_equal(got.astype(np.uint64), want)


def test_fused_matvec_on_device(rng):
    """The fused kernel's module product (ML-DSA pattern) vs the XLA
    plan on the card, f32-Barrett flavor."""
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.transform import Plan
    p = preset("dilithium256")
    plan = Plan(p)
    mv = FusedPolymul(plan)
    r, c = 4, 4
    A = rng.integers(0, p.q, (8, r, c, p.n)).astype(np.int32)
    s = rng.integers(0, p.q, (8, c, p.n)).astype(np.int32)
    got = np.asarray(mv.matvec(A, s))
    want = np.asarray(plan.matvec_jit(A, s))
    np.testing.assert_array_equal(got, want)

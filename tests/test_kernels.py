"""Fused-kernel tests (ops/fused.py in interpret mode on CPU; the compiled
kernel runs in tests/test_gpu_parity.py and chip_smoke.py) and the matmul
backend (ops/matmul_ntt.py)."""

import numpy as np
import pytest

from tpu_ntt import ref
from tpu_ntt.ops.fused import MAX_N, ROWS, FusedPolymul, supported
from tpu_ntt.params import find_params, make_params, preset
from tpu_ntt.schemes import IncompletePlan
from tpu_ntt.transform import Plan


def _fused(p):
    return FusedPolymul(Plan(p), interpret=True)


def _kyber():
    return IncompletePlan(256, 3329, levels=1)


def _matvec_oracle(A, s, q):
    r, c = A.shape[-3], A.shape[-2]
    out = np.zeros(A.shape[:-3] + (r, A.shape[-1]), dtype=np.int64)
    for idx in np.ndindex(*A.shape[:-3]):
        for i in range(r):
            for j in range(c):
                out[idx + (i,)] += ref.schoolbook_negacyclic(
                    A[idx + (i, j)], s[idx + (j,)], q)
    return out % q


@pytest.mark.parametrize("name", ["sw256", "hw256", "kyber128",
                                  "dilithium256"])
def test_pallas_polymul_bit_exact(rng, name):
    p = preset(name)
    pk = _fused(p)
    a = rng.integers(0, p.q, (10, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (10, p.n)).astype(np.int32)
    c = np.asarray(pk.polymul(a, b))
    np.testing.assert_array_equal(c, ref.schoolbook_rows(a, b, p.q))
    assert c.min() >= 0 and c.max() < p.q


def test_pallas_matches_xla_plan(rng):
    p = preset("sw256")
    a = rng.integers(0, p.q, (ROWS, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (ROWS, p.n)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(_fused(p).polymul(a, b)),
                                  np.asarray(Plan(p).polymul_jit(a, b)))


@pytest.mark.parametrize("batch", [1, 5, ROWS + 3])
def test_pallas_batch_padding(rng, batch):
    """Batches that are not a multiple of ROWS are padded internally;
    leading axes beyond the batch are kept."""
    p = preset("sw256")
    pk = _fused(p)
    a = rng.integers(0, p.q, (batch, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (batch, p.n)).astype(np.int32)
    c = np.asarray(pk.polymul(a, b))
    assert c.shape == (batch, p.n)
    np.testing.assert_array_equal(c, ref.schoolbook_rows(a, b, p.q))
    c3 = np.asarray(pk.polymul(a.reshape(batch, 1, p.n),
                               b.reshape(batch, 1, p.n)))
    np.testing.assert_array_equal(c3.reshape(batch, p.n), c)


def test_pallas_extreme_inputs():
    """All-(q-1) inputs at the range edge."""
    p = preset("sw256")
    a = np.full((4, p.n), p.q - 1, dtype=np.int32)
    c = np.asarray(_fused(p).polymul(a, a))
    np.testing.assert_array_equal(
        c[0], ref.schoolbook_negacyclic(a[0], a[0], p.q))


def test_pallas_unsupported_q():
    """The envelope: power-of-two 16 <= n <= MAX_N, odd q < 2^29 with the
    needed roots; anything else is refused, and without a GPU the kernel
    runs only in interpret mode."""
    assert supported(256, preset("dilithium256").q)
    assert supported(256, 3329, levels=1)
    assert not supported(256, 3329)                  # no 512th root
    assert not supported(256, find_params(256, 30).q)   # q >= 2^29
    assert not supported(2 * MAX_N, 12289)
    assert not supported(8, 17)
    assert not supported(256, 7681, negacyclic=False, levels=1)
    with pytest.raises(ValueError):
        _fused(make_params(2 * MAX_N, 12289))
    with pytest.raises(RuntimeError, match="GPU"):
        FusedPolymul(Plan(preset("sw256")))


def test_pallas_mont_extreme_inputs():
    """All-(q-1) inputs at the Montgomery bound q just under 2^29."""
    p = find_params(256, 29)
    assert (1 << 28) < p.q < (1 << 29)
    a = np.full((2, p.n), p.q - 1, dtype=np.int32)
    c = np.asarray(_fused(p).polymul(a, a))
    want = ref.schoolbook_negacyclic(
        a[0].astype(object), a[0].astype(object), p.q)
    np.testing.assert_array_equal(c[0].astype(object), want)


def test_pallas_mont_matches_xla_plan(rng):
    p = find_params(256, 28)
    a = rng.integers(0, p.q, (4, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (4, p.n)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(_fused(p).polymul(a, b)),
                                  np.asarray(Plan(p).polymul_jit(a, b)))


@pytest.mark.parametrize("n", [16, 64, 512, MAX_N])
def test_pallas_other_n(rng, n):
    p = make_params(n, 12289)
    a = rng.integers(0, p.q, (2, n)).astype(np.int32)
    b = rng.integers(0, p.q, (2, n)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(_fused(p).polymul(a, b)),
                                  ref.schoolbook_rows(a, b, p.q))


@pytest.mark.parametrize("p", [preset("sw256"), preset("dilithium256"),
                               find_params(256, 28)],
                         ids=["shoup", "f32", "mont"])
def test_pallas_standalone_transforms_match_plan(rng, p):
    """The forward-only and inverse-only kernels are drop-in twins of
    Plan.forward and Plan.inverse in every arithmetic flavor."""
    pk, plan = _fused(p), Plan(p)
    x = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    f = np.asarray(plan.forward_jit(x))
    np.testing.assert_array_equal(np.asarray(pk.forward(x)), f)
    np.testing.assert_array_equal(np.asarray(pk.inverse(f)),
                                  np.asarray(plan.inverse_jit(f)))


def test_pallas_cyclic_ring(rng):
    """x^n - 1 (psi=0 tables) — the FPGA hardware-flow semantics."""
    p = make_params(256, 7681, negacyclic=False)
    a = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(_fused(p).polymul(a, b)),
        ref.schoolbook_rows(a, b, p.q, negacyclic=False))


# ---------------------------------------------------------------------------
# incomplete NTT (Kyber's ring, levels=1)
# ---------------------------------------------------------------------------

def test_pallas_incomplete_kyber_bit_exact(rng):
    pk = FusedPolymul(_kyber(), interpret=True)
    a = rng.integers(0, 3329, (6, 256)).astype(np.int32)
    b = rng.integers(0, 3329, (6, 256)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(pk.polymul(a, b)),
                                  ref.schoolbook_rows(a, b, 3329))


def test_pallas_incomplete_matches_incomplete_plan(rng):
    """polymul and the two-spectrum forward/inverse equal the XLA
    IncompletePlan's."""
    plan = _kyber()
    pk = FusedPolymul(plan, interpret=True)
    a = rng.integers(0, 3329, (3, 256)).astype(np.int32)
    b = rng.integers(0, 3329, (3, 256)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(pk.polymul(a, b)),
                                  np.asarray(plan.polymul(a, b)))
    f, fp = pk.forward(a), plan.forward(a)
    assert len(f) == len(fp) == 2
    for x, y in zip(f, fp):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(pk.inverse(f)),
                                  np.asarray(plan.inverse(fp)))


def test_pallas_incomplete_extreme_inputs():
    pk = FusedPolymul(_kyber(), interpret=True)
    a = np.full((2, 256), 3328, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(pk.polymul(a, a))[0],
                                  ref.schoolbook_negacyclic(a[0], a[0], 3329))


def test_pallas_incomplete_rejects_big_q():
    """levels=1 still needs the int32 arithmetic's q < 2^29, and only
    levels 0 and 1 are fused."""
    assert not supported(256, (1 << 29) + 257, levels=1)
    with pytest.raises(ValueError):
        FusedPolymul(IncompletePlan(256, 2689), interpret=True)                     # levels=2


def test_pallas_incomplete_matvec_matches_plan(rng):
    plan = _kyber()
    pk = FusedPolymul(plan, interpret=True)
    A = rng.integers(0, 3329, (2, 3, 3, 256)).astype(np.int32)
    s = rng.integers(0, 3329, (2, 3, 256)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(pk.matvec(A, s)),
                                  np.asarray(plan.matvec(A, s)))


def test_pallas_incomplete_matvec_extreme():
    pk = FusedPolymul(_kyber(), interpret=True)
    A = np.full((1, 2, 2, 256), 3328, dtype=np.int32)
    s = np.full((1, 2, 256), 3328, dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(pk.matvec(A, s)),
                                  _matvec_oracle(A, s, 3329))


@pytest.mark.parametrize("p", [preset("sw256"), preset("dilithium256"),
                               find_params(256, 28)],
                         ids=["shoup", "f32", "mont"])
def test_pallas_full_matvec_matches_plan(rng, p):
    """The module product (kernel transforms around the XLA
    multiply-accumulate) equals Plan.matvec in every flavor."""
    pk = _fused(p)
    A = rng.integers(0, p.q, (2, 2, 3, p.n)).astype(np.int32)
    s = rng.integers(0, p.q, (2, 3, p.n)).astype(np.int32)
    A[0, 0, 0] = p.q - 1
    s[0, 0] = p.q - 1
    np.testing.assert_array_equal(np.asarray(pk.matvec(A, s)),
                                  np.asarray(Plan(p).matvec_jit(A, s)))


def test_pallas_matvec_shape_mismatch():
    pk = _fused(preset("sw256"))
    with pytest.raises(ValueError, match="matvec shape"):
        pk.matvec(np.zeros((1, 2, 3, 256), np.int32),
                  np.zeros((1, 2, 256), np.int32))


# ---------------------------------------------------------------------------
# matmul backend
# ---------------------------------------------------------------------------

def test_matmul_polymul_bit_exact(rng):
    from tpu_ntt.ops.matmul_ntt import MatmulNTT
    p = preset("sw256")
    m = MatmulNTT(p)
    a = rng.integers(0, p.q, (6, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (6, p.n)).astype(np.int32)
    c = np.asarray(m.polymul_jit(a, b))
    np.testing.assert_array_equal(c, ref.schoolbook_rows(a, b, p.q))


def test_matmul_exactness_edge():
    """n=1024 with all-(q-1) inputs sits at the f32-accumulation bound
    (127²·1024 < 2^24) — must still be exact."""
    from tpu_ntt.ops.matmul_ntt import MatmulNTT
    p = make_params(1024, 12289)
    a = np.full((2, 1024), p.q - 1, dtype=np.int32)
    c = np.asarray(MatmulNTT(p).polymul_jit(a, a))
    np.testing.assert_array_equal(
        c[0], ref.schoolbook_negacyclic(a[0], a[0], p.q))


def test_matmul_unsupported():
    from tpu_ntt.ops.matmul_ntt import MatmulNTT
    from tpu_ntt.ops.matmul_ntt import supported as mm_supported
    assert not mm_supported(preset("dilithium256"))     # q too big
    assert not mm_supported(make_params(2048, 12289))   # n too big
    with pytest.raises(ValueError):
        MatmulNTT(preset("dilithium256"))


def test_matmul_matches_xla_plan(rng):
    from tpu_ntt.ops.matmul_ntt import MatmulNTT
    p = preset("hw256")
    a = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    b = rng.integers(0, p.q, (3, p.n)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(MatmulNTT(p).polymul_jit(a, b)),
        np.asarray(Plan(p).polymul_jit(a, b)))


def test_matmul_engine_backend(rng):
    """backend='matmul' reaches MatmulNTT through the engine and Ring."""
    from tpu_ntt.ring import Ring
    R = Ring(256, 12289, backend="matmul")
    assert R._engine.kind == "matmul"
    a, b = R.random((2, 256), rng), R.random((2, 256), rng)
    np.testing.assert_array_equal(R.mul(a, b),
                                  ref.schoolbook_rows(a, b, 12289))

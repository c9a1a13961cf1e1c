"""Ring — the one-import user surface — as a first-class tested API.

Pins every public method and every dispatch mode (negacyclic / cyclic /
kyber-incomplete / big-q / mesh), plus the transform-domain contract,
per VERDICT r4 weak #5.  The cyclic ring is the HARDWARE's own product
semantics (PolyMult.v:176-238 — no psi twist anywhere in the RTL flow),
so its oracle here is both ``ref.schoolbook_cyclic`` and the bit-exact
GO-flow twin ``ref.hw_polymul``.
"""

import jax
import numpy as np
import pytest

from tpu_ntt import ref
from tpu_ntt.params import make_params
from tpu_ntt.ring import Ring


# ---------------------------------------------------------------------------
# ring arithmetic, both flavors
# ---------------------------------------------------------------------------

def test_negacyclic_mul_and_helpers(rng):
    R = Ring(256, 12289)
    assert R.negacyclic and R.n == 256 and R.q == 12289
    a, b = R.random(256, rng), R.random(256, rng)
    np.testing.assert_array_equal(
        R.mul(a, b), ref.schoolbook_negacyclic(a, b, R.q))
    np.testing.assert_array_equal(R.add(a, b), (a + b) % R.q)
    np.testing.assert_array_equal(R.sub(a, b), (a - b) % R.q)
    np.testing.assert_array_equal(R.scalar_mul(7, a), 7 * a % R.q)
    assert R.random((3, 256), rng).shape == (3, 256)
    assert "x^256 + 1" in repr(R)


def test_cyclic_mul_vs_schoolbook_and_hw_flow(rng):
    """The hw256 point, cyclic — dispatches through the engine and
    matches both the schoolbook and the RTL GO-flow twin bit-exactly."""
    R = Ring(256, 7681, negacyclic=False)
    assert not R.negacyclic
    assert "x^256 - 1" in repr(R)
    a, b = R.random(256, rng), R.random(256, rng)
    c = R.mul(a, b)
    np.testing.assert_array_equal(c, ref.schoolbook_cyclic(a, b, R.q))
    p = make_params(256, 7681, negacyclic=False)
    np.testing.assert_array_equal(
        c.astype(np.int64), ref.hw_polymul(a.astype(np.int64),
                                           b.astype(np.int64), p))


def test_cyclic_only_needs_nth_root(rng):
    """q ≡ 1 (mod n) but NOT (mod 2n): negacyclic impossible, cyclic
    fine — the structural requirement relaxes for x^n - 1."""
    q = 257                      # q-1 = 256 = n, not divisible by 2n
    R = Ring(256, q, negacyclic=False)
    a, b = R.random(256, rng), R.random(256, rng)
    np.testing.assert_array_equal(R.mul(a, b),
                                  ref.schoolbook_cyclic(a, b, q))
    # the negacyclic ring truly cannot exist at this q: make_params
    # degrades to psi=0 even when asked for negacyclic
    assert make_params(256, q).negacyclic is False


def test_cyclic_unfriendly_q_raises():
    """No n-th root at all -> loud structural error, not silent junk."""
    with pytest.raises(NotImplementedError, match="cyclic ring needs"):
        Ring(256, 3331, negacyclic=False)


def test_batch_shape_preserved(rng):
    R = Ring(256, 12289)
    a1, b1 = R.random(256, rng), R.random(256, rng)
    assert R.mul(a1, b1).shape == (256,)
    a2, b2 = R.random((3, 256), rng), R.random((3, 256), rng)
    out = R.mul(a2, b2)
    assert out.shape == (3, 256)
    for i in range(3):
        np.testing.assert_array_equal(
            out[i], ref.schoolbook_negacyclic(a2[i], b2[i], R.q))


# ---------------------------------------------------------------------------
# transform domain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("negacyclic", [True, False])
def test_transform_domain_contract(rng, negacyclic):
    """intt(ntt(a)) == a AND intt(pointwise(ntt(a), ntt(b))) == mul(a,b)
    hold simultaneously, for both ring flavors."""
    R = Ring(256, 7681, negacyclic=negacyclic)
    a, b = R.random((2, 256), rng), R.random((2, 256), rng)
    fa, fb = R.ntt(a), R.ntt(b)
    np.testing.assert_array_equal(R.intt(fa), a % R.q)
    np.testing.assert_array_equal(R.intt(R.pointwise(fa, fb)),
                                  R.mul(a, b))


def test_transform_domain_montgomery_fix(rng):
    """Dilithium q (MontArith, pointwise_fix != 1): the stray Montgomery
    factor is corrected so both identities hold."""
    q = 8380417
    R = Ring(256, q)
    a, b = R.random((1, 256), rng), R.random((1, 256), rng)
    np.testing.assert_array_equal(R.intt(R.ntt(a)), a % q)
    np.testing.assert_array_equal(
        R.intt(R.pointwise(R.ntt(a), R.ntt(b))), R.mul(a, b))


# ---------------------------------------------------------------------------
# dispatch modes
# ---------------------------------------------------------------------------

def test_kyber_incomplete_dispatch(rng):
    R = Ring(256, 3329)
    assert "incomplete" in repr(R)
    a, b = R.random(256, rng), R.random(256, rng)
    np.testing.assert_array_equal(
        R.mul(a, b), ref.schoolbook_negacyclic(a, b, 3329))
    # incomplete transform domain still honors the contract
    fa, fb = R.ntt(a[None]), R.ntt(b[None])
    np.testing.assert_array_equal(R.intt(R.pointwise(fa, fb))[0],
                                  R.mul(a, b))


def test_bigq_dispatch_and_polymul_only_contract(rng):
    """62-bit q routes to the RNS plan; transform-domain ops state the
    polymul-only contract instead of failing deep inside."""
    from tpu_ntt.params import find_params
    p = find_params(4096, 62)
    R = Ring(4096, p.q)
    assert R._engine.kind == "bigq"
    # sparse product: schoolbook at n=4096 python-int is too slow; two
    # 3-term operands exercise the full pipeline with an exact oracle
    a = np.zeros(4096, dtype=np.uint64)
    b = np.zeros(4096, dtype=np.uint64)
    idx = [(0, p.q - 1), (1, 12345678901234567), (4095, p.q - 2)]
    for i, v in idx:
        a[i] = v
        b[(i * 7) % 4096] = (v * 3) % p.q
    c = R.mul(a, b)
    want = np.zeros(4096, dtype=object)
    for i, av in idx:
        for j, bv in [((k * 7) % 4096, (v * 3) % p.q) for k, v in idx]:
            k = i + j
            s = 1 if k < 4096 else -1
            want[k % 4096] = (want[k % 4096] + s * int(av) * int(bv)) % p.q
    np.testing.assert_array_equal(c.astype(object), want)
    with pytest.raises(NotImplementedError, match="polymul only"):
        R.ntt(a)


def test_mesh_dispatch(rng):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from tpu_ntt.parallel.sharded import make_mesh
    R = Ring(1024, 12289, mesh=make_mesh(8))
    assert R._engine.kind == "sharded"
    a, b = R.random((2, 1024), rng), R.random((2, 1024), rng)
    out = R.mul(a, b)
    for i in range(2):
        np.testing.assert_array_equal(
            out[i], ref.schoolbook_negacyclic(a[i], b[i], R.q))


def test_cyclic_mesh_and_fourstep_paths(rng):
    """Cyclic rings are exact through the OTHER engine backends too:
    the sharded four-step over 8 devices and the four-step plan on a
    one-device mesh — psi=0 tables everywhere."""
    if len(jax.devices()) >= 8:
        from tpu_ntt.parallel.sharded import make_mesh
        R = Ring(1024, 12289, negacyclic=False, mesh=make_mesh(8))
        assert R._engine.kind == "sharded"
        a, b = R.random((2, 1024), rng), R.random((2, 1024), rng)
        c = R.mul(a, b)
        for i in range(2):
            np.testing.assert_array_equal(
                c[i], ref.schoolbook_cyclic(a[i], b[i], 12289))
    from tpu_ntt.parallel.sharded import ShardedPlan, make_mesh
    p = make_params(1 << 12, 12289, negacyclic=False)
    fs = ShardedPlan(p, make_mesh(1))
    a1 = rng.integers(0, p.q, (1, p.n)).astype(np.int32)
    b1 = rng.integers(0, p.q, (1, p.n)).astype(np.int32)
    got = fs.unshard(fs.polymul_jit(fs.shard_coeffs(a1),
                                    fs.shard_coeffs(b1)))
    np.testing.assert_array_equal(
        got[0], ref.schoolbook_cyclic(a1[0], b1[0], p.q))

"""Four-step plan tests: the XLA ShardedPlan on a one-device mesh, which
serves every ring past 8192 points (large, large23, xlarge and the big-q
channels), in each arithmetic flavor."""

import numpy as np
import pytest

from tpu_ntt.params import find_params, make_params
from tpu_ntt.parallel.sharded import ShardedPlan, make_mesh
from tpu_ntt.transform import Plan


def _fourstep(p, a, b):
    sp = ShardedPlan(p, make_mesh(1))
    return sp.unshard(sp.polymul_jit(sp.shard_coeffs(a), sp.shard_coeffs(b)))


def _flat(p, a, b):
    return np.asarray(Plan(p).polymul_jit(a, b))


def test_fourstep_mont_bit_exact(rng):
    """28-bit prime (large-config class, Montgomery flavor): four-step ==
    flat XLA Plan, including all-(q-1) rows."""
    p = find_params(4096, 28)
    a = rng.integers(0, p.q, (3, 4096)).astype(np.int32)
    b = rng.integers(0, p.q, (3, 4096)).astype(np.int32)
    a[1] = p.q - 1
    b[1] = p.q - 1
    np.testing.assert_array_equal(_fourstep(p, a, b), _flat(p, a, b))


def test_fourstep_shoup_bit_exact(rng):
    """Reference SW modulus q=12289 at n=4096 through the Shoup flavor."""
    p = make_params(4096, 12289)
    a = rng.integers(0, p.q, (3, 4096)).astype(np.int32)
    b = rng.integers(0, p.q, (3, 4096)).astype(np.int32)
    a[0] = p.q - 1
    b[0] = p.q - 1
    np.testing.assert_array_equal(_fourstep(p, a, b), _flat(p, a, b))


def test_fourstep_cyclic(rng):
    """x^n - 1 ring (psi=0) — the FPGA hardware-flow semantics."""
    p = make_params(4096, 12289, negacyclic=False)
    a = rng.integers(0, p.q, (2, 4096)).astype(np.int32)
    b = rng.integers(0, p.q, (2, 4096)).astype(np.int32)
    np.testing.assert_array_equal(_fourstep(p, a, b), _flat(p, a, b))


def test_fourstep_batch_padding(rng):
    """An odd batch through the engine's four-step path (n > 8192)."""
    from tpu_ntt.runtime.engine import PolyMultEngine
    p = make_params(16384, 65537)
    eng = PolyMultEngine(p.n, p.q)
    assert eng.kind == "fourstep"
    a = rng.integers(0, p.q, (3, p.n))
    b = rng.integers(0, p.q, (3, p.n))
    c = eng.multiply(a, b)
    assert c.shape == (3, p.n)
    np.testing.assert_array_equal(c[2], eng.multiply(a[2:], b[2:])[0])


@pytest.mark.parametrize("n,split", [(4096, (64, 64)), (1 << 15, (256, 128))])
def test_fourstep_explicit_split(n, split):
    """n = n1·n2 with the factors as square as possible."""
    sp = ShardedPlan(find_params(n, 28), make_mesh(1))
    assert (sp.n1, sp.n2) == split


@pytest.mark.parametrize("n,q,kind", [(8192, 65537, "xla"),
                                      (16384, 65537, "fourstep"),
                                      (16384, (1 << 61) - 1, "bigq")])
def test_fourstep_supported_gate(n, q, kind):
    """The platform rule hands rings past 8192 points to the four-step
    plan on both platforms; big q goes to the RNS channels."""
    from tpu_ntt.dispatch import select_plan
    for platform in ("cpu", "gpu"):
        assert select_plan(n, q, platform=platform) == kind


def test_fourstep_f32_bit_exact(rng):
    """Float-assisted-Barrett flavor (2^15 <= q < 2^23) at n=4096,
    including all-(q-1) rows."""
    from tpu_ntt.params import find_ntt_prime
    q = find_ntt_prime(22, 4096)
    p = make_params(4096, q)
    a = rng.integers(0, q, (2, 4096)).astype(np.int32)
    b = rng.integers(0, q, (2, 4096)).astype(np.int32)
    a[1] = q - 1
    b[1] = q - 1
    np.testing.assert_array_equal(_fourstep(p, a, b), _flat(p, a, b))


def test_blocked_fourstep_sparse_exact():
    """n=2^17 through the engine: sparse operands give an exact
    hand-computable negacyclic oracle."""
    from tpu_ntt.runtime.engine import PolyMultEngine
    n = 1 << 17
    p = find_params(n, 28)
    eng = PolyMultEngine(n, p.q)
    a = np.zeros((1, n), np.int64)
    b = np.zeros((1, n), np.int64)
    a[0, 0], a[0, n - 1] = 3, 5                # a = 3 + 5·x^(n-1)
    b[0, 0], b[0, 2] = 7, 2                    # b = 7 + 2·x^2
    want = np.zeros(n, np.int64)
    want[0] = 3 * 7
    want[2] = 3 * 2
    want[n - 1] = 5 * 7
    want[1] = (-5 * 2) % p.q                   # x^(n+1) wraps to -x^1
    np.testing.assert_array_equal(eng.multiply(a, b)[0], want % p.q)

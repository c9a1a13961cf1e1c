"""Opt-in input-domain validation at plan boundaries (the rebuild's
answer to the reference's compiled-out range asserts, ntt_red.c:42,79)."""

import numpy as np
import pytest

import tpu_ntt
from tpu_ntt import DomainError, validated
from tpu_ntt.params import preset
from tpu_ntt.runtime.engine import PolyMultEngine


def test_validation_off_by_default(rng):
    assert not tpu_ntt.validation_enabled()
    eng = PolyMultEngine(n=256, q=12289, backend="xla")
    a = np.full((1, 256), 12289, dtype=np.int64)    # == q: out of range
    eng.multiply(a, a)                              # silently garbage: OK


def test_engine_rejects_out_of_range(rng):
    eng = PolyMultEngine(n=256, q=12289, backend="xla")
    good = rng.integers(0, 12289, (1, 256))
    bad_hi = good.copy()
    bad_hi[0, 7] = 12289
    bad_lo = good.copy()
    bad_lo[0, 0] = -1
    with validated():
        c = eng.multiply(good, good)                # canonical passes
        assert c.max() < 12289
        with pytest.raises(DomainError):
            eng.multiply(bad_hi, good)
        with pytest.raises(DomainError):
            eng.multiply(good, bad_lo)


def test_pallas_boundary_validation(rng):
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.transform import Plan
    pk = FusedPolymul(Plan(preset("sw256")), interpret=True)
    a = rng.integers(0, 12289, (2, 256)).astype(np.int32)
    bad = a.copy()
    bad[1, 3] = 20000
    with validated():
        pk.polymul(a, a)
        with pytest.raises(DomainError):
            pk.polymul(a, bad)


def test_validation_skips_traced_values(rng):
    """Entry points stay jit-composable: traced operands are not checked."""
    import jax
    from tpu_ntt.ops.fused import FusedPolymul
    from tpu_ntt.transform import Plan
    pk = FusedPolymul(Plan(preset("sw256")), interpret=True)
    a = rng.integers(0, 12289, (2, 256)).astype(np.int32)
    with validated():
        out = jax.jit(lambda x, y: pk.polymul(x, y))(a, a)
    assert np.asarray(out).shape == (2, 256)


def test_sharded_and_bigq_validation(rng):
    from tpu_ntt.parallel.sharded import ShardedPlan, make_mesh
    from tpu_ntt.bigq import BigQPlan
    from tpu_ntt.params import find_params, make_params
    sp = ShardedPlan(make_params(1024, 12289), make_mesh(1))
    bq = BigQPlan(find_params(256, 45))
    with validated():
        with pytest.raises(DomainError):
            sp.shard_coeffs(np.full((1, 1024), 12289))
        with pytest.raises(DomainError):
            bq.polymul(np.full((1, 256), bq.params.q, dtype=np.uint64),
                       np.zeros((1, 256), dtype=np.uint64))

"""Modular-arithmetic strategy tests (int32-lane exactness proofs by
exhaustive-ish sampling + adversarial corners) — the vectorised twin of the
reference's range assertions (ntt_red.c:42,79) and word-level reduction
verification (ModRed_sub.v behaviour)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_ntt.ops.modmul import (FBarrettArith, MontArith, ShoupArith,
                                select_arith)

QS_SMALL = [3329, 7681, 12289, 32749]                 # q < 2^15
QS_MED = [8380417, 133_169_153, 268_369_921]          # 2^15 <= q < 2^29


def _rand_pairs(rng, q, k=100_000):
    x = rng.integers(0, q, k).astype(np.int32)
    y = rng.integers(0, q, k).astype(np.int32)
    # adversarial corners: extremes of the canonical range
    corners = [(0, 0), (q - 1, q - 1), (q - 1, 1), (1, q - 1), (0, q - 1)]
    for i, (a, b) in enumerate(corners):
        x[i], y[i] = a, b
    return x, y


@pytest.mark.parametrize("q", QS_SMALL)
def test_shoup_mul_const_exact(q, rng):
    ar = ShoupArith(q)
    x, _ = _rand_pairs(rng, q)
    for w in [0, 1, q - 1, q // 2, 2]:
        tab = tuple(jnp.asarray(t) for t in ar.const_table(np.array([w])))
        got = np.asarray(jax.jit(lambda v: ar.mul_const(v, tab))(x))
        want = x.astype(np.int64) * w % q
        np.testing.assert_array_equal(got, want, err_msg=f"w={w}")


@pytest.mark.parametrize("q", QS_SMALL)
def test_shoup_mul_exact(q, rng):
    ar = ShoupArith(q)
    x, y = _rand_pairs(rng, q)
    got = np.asarray(jax.jit(ar.mul)(x, y))
    want = x.astype(np.int64) * y.astype(np.int64) % q
    np.testing.assert_array_equal(got, want)
    assert got.max() < q and got.min() >= 0


@pytest.mark.parametrize("q", QS_MED)
def test_mont_mul_exact(q, rng):
    ar = MontArith(q)
    x, y = _rand_pairs(rng, q)
    got = np.asarray(jax.jit(ar.mul)(x, y)).astype(np.int64)
    rinv = pow(ar.R, -1, q)
    want = x.astype(object) * y.astype(object) * rinv % q
    np.testing.assert_array_equal(got, np.array(want.tolist(), dtype=np.int64))


@pytest.mark.parametrize("q", QS_MED)
def test_mont_const_plain_domain(q, rng):
    """Constants stored in Montgomery form give plain results — the
    R-scaled-twiddle scheme of the hardware (W.txt, test_generator.py:188)."""
    ar = MontArith(q)
    x, _ = _rand_pairs(rng, q)
    for w in [0, 1, q - 1, 12345 % q]:
        tab = ar.const_table(np.array([w]))
        got = np.asarray(jax.jit(lambda v: ar.mul_const(v, tab)))
        got = np.asarray(jax.jit(lambda v: ar.mul_const(v, tab))(x))
        want = x.astype(np.int64) * w % q
        np.testing.assert_array_equal(got, want, err_msg=f"w={w}")


@pytest.mark.parametrize("q", QS_SMALL + QS_MED)
def test_add_sub(q, rng):
    ar = select_arith(q)
    x, y = _rand_pairs(rng, q, 10_000)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(ar.add)(x, y)), (x.astype(np.int64) + y) % q)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(ar.sub)(x, y)), (x.astype(np.int64) - y) % q)


def test_select_arith():
    assert isinstance(select_arith(12289), ShoupArith)
    assert isinstance(select_arith(8380417), FBarrettArith)
    assert isinstance(select_arith(133_169_153), MontArith)
    with pytest.raises(NotImplementedError):
        select_arith(1 << 30)
    with pytest.raises(ValueError):
        ShoupArith(1 << 15)
    with pytest.raises(ValueError):
        MontArith(1 << 29)
    with pytest.raises(ValueError):
        FBarrettArith(1 << 23)


def test_no_int32_overflow_in_shoup():
    """Worst-case product x·w' stays below 2^31 (the proof obligation in
    the ShoupArith docstring), checked at the numeric extremes."""
    q = (1 << 15) - 19                       # largest prime < 2^15 is fine
    x = (1 << 15) - 1
    w_sh = ((q - 1) << 16) // q              # largest companion
    assert x * w_sh < 2 ** 31


def test_mont_internal_bounds():
    """REDC intermediate bounds from the derivation in modmul.py hold at
    the extremes (no silent int32 wrap)."""
    q = (1 << 29) - 3                        # worst-case magnitude
    M = (1 << 15) - 1
    L0 = M * M
    u0q0 = M * (q & M)
    assert L0 + u0q0 < 2 ** 31
    Mid = 2 * ((1 << 14) - 1) * M
    u0q1 = M * (q >> 15)
    t1 = (L0 + u0q0) >> 15
    assert Mid + u0q1 + t1 < 2 ** 31


QS_F32 = [32771, 65537, 995329, 8380417, (1 << 23) - 1]   # 2^15 <= q < 2^23


@pytest.mark.parametrize("q", QS_F32)
def test_fbarrett_mul_const_exact(q, rng):
    """Float-assisted Barrett constant multiply is exact over the full
    canonical range AND the lazy [0, 2q) input range the kernels use."""
    ar = FBarrettArith(q)
    x = rng.integers(0, 2 * q, 100_000).astype(np.int32)
    x[:4] = [0, q - 1, 2 * q - 1, q]
    for w in [0, 1, q - 1, q // 2, 3]:
        tab = ar.const_table(np.array([w]))
        tab = (jnp.asarray(tab[0]), jnp.asarray(tab[1]))
        got = np.asarray(jax.jit(
            lambda v: ar.mul_const(v, tab))(x)).astype(np.int64)
        want = x.astype(np.int64) * w % q
        np.testing.assert_array_equal(got, want, err_msg=f"w={w}")
        lazy = np.asarray(jax.jit(
            lambda v: ar.mul_const(v, tab, lazy=True))(x)).astype(np.int64)
        assert lazy.max() < 2 * q and lazy.min() >= 0
        np.testing.assert_array_equal(lazy % q, want, err_msg=f"w={w} lazy")


@pytest.mark.parametrize("q", QS_F32)
def test_fbarrett_mul_const_dense_w_sweep(q, rng):
    """Adversarial twiddle sweep: many random w, plus boundary x values
    where the f32 quotient estimate error peaks."""
    ar = FBarrettArith(q)
    ws = np.concatenate([rng.integers(0, q, 500),
                         np.array([0, 1, 2, q - 2, q - 1])])
    tab = ar.const_table(ws)
    tab = (jnp.asarray(tab[0]), jnp.asarray(tab[1]))
    x = np.concatenate([rng.integers(0, 2 * q, 500),
                        np.array([0, 1, q - 1, 2 * q - 1, q])]).astype(np.int32)
    got = np.asarray(jax.jit(
        lambda v: ar.mul_const(v[:, None], tab))(x)).astype(np.int64)
    want = x[:, None].astype(np.int64) * ws[None, :].astype(np.int64) % q
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", QS_F32)
def test_fbarrett_mul_exact(q, rng):
    ar = FBarrettArith(q)
    x, y = _rand_pairs(rng, q)
    got = np.asarray(jax.jit(ar.mul)(x, y)).astype(np.int64)
    want = x.astype(np.int64) * y.astype(np.int64) % q
    np.testing.assert_array_equal(got, want)
    assert got.max() < q and got.min() >= 0
    assert ar.pointwise_fix == 1

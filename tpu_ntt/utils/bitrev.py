"""Bit-reversal permutation utilities.

Vectorised replacements for the reference's bit-reversal helpers:
- ``intReverse``/``indexReverse`` (Hardware_Multiplier/test_generator/helper.py:38-49)
- ``bitrev_shuffle`` (NTT_Software/.../NTT/ntt.C:27-44)
- ``bit_reverse_index`` (Hardware_Multiplier/PolyMult.v:81-87)

We precompute permutation index vectors (cheap, host-side, cached) and apply
them as gathers; inside jit these compile to a single XLA gather/transpose.
The fast transform paths avoid materialising bit-reversal entirely by pairing
std2rev forward with rev2std inverse (the reference's own trick,
NTT-RED/ntt_red256.C:8,23).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["bit_reverse_int", "bit_reverse_indices", "bit_reverse_permute"]


def bit_reverse_int(x: int, bits: int) -> int:
    """Reverse the lowest ``bits`` bits of the non-negative integer ``x``."""
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def bit_reverse_indices(n: int) -> np.ndarray:
    """Index vector ``rev`` with ``rev[i] = bit_reverse(i, log2 n)``.

    ``a[rev]`` puts a natural-order array into bit-reversed order (and vice
    versa; the permutation is an involution).
    """
    if n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    x = idx.copy()
    for _ in range(bits):
        rev = (rev << 1) | (x & 1)
        x >>= 1
    return rev


def bit_reverse_permute(a, axis: int = -1):
    """Apply the bit-reversal permutation along ``axis`` (numpy or jax array)."""
    n = a.shape[axis]
    rev = bit_reverse_indices(n)
    return a.take(rev, axis=axis)

"""ML-DSA-style module products: A_hat·s_hat through the engine's plan.

The hot pattern of Dilithium-style schemes is a matrix of ring elements
times a vector of ring elements: c vector transforms, r·c matrix
transforms, a spectral multiply-accumulate and r shared inverse
transforms, instead of r·c full products.  The engine's plan (the fused
kernel on a GPU, the XLA ``Plan`` on the CPU) provides ``matvec``.

Run:  python examples/mldsa_matvec.py
"""

import numpy as np

from tpu_ntt import PolyMultEngine, preset, ref

p = preset("dilithium256")                 # n=256, q=8380417 (f32 flavor)
eng = PolyMultEngine(p.n, p.q)

r, c, batch = 4, 4, 8
rng = np.random.default_rng(0)
A = rng.integers(0, p.q, (batch, r, c, p.n)).astype(np.int32)
s = rng.integers(0, p.q, (batch, c, p.n)).astype(np.int32)

t = np.asarray(eng.plan.matvec_jit(A, s))  # (batch, r, n)
print(f"matvec ({eng.kind}): A {A.shape} x s {s.shape} -> {t.shape}")

# verify row 0 of batch 0 against the schoolbook oracle
want = np.zeros(p.n, dtype=np.int64)
for j in range(c):
    want = (want + ref.schoolbook_negacyclic(
        A[0, 0, j].astype(object), s[0, j].astype(object), p.q)) % p.q
assert np.array_equal(t[0, 0].astype(np.int64), want)
print("row (0,0) matches the schoolbook oracle")

"""Batched ML-KEM-style polynomial products through the public Ring API.

The q=3329 ring has no 512th root of unity, so the transform is the
levels=1 incomplete NTT.  ``Ring`` asks the platform rule
(``tpu_ntt.dispatch.select_plan``) for the plan: the fused kernel on a
GPU, the XLA ``IncompletePlan`` on the CPU.  The timed call is the served
path: host arrays in, host arrays out.

Run:  python examples/kyber_throughput.py [batch]
"""

import sys
import time

import numpy as np

from tpu_ntt import Ring, ref

batch = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
n, q = 256, 3329
R = Ring(n, q)

rng = np.random.default_rng(0)
a = R.random((batch, n), rng)
b = R.random((batch, n), rng)

c = R.mul(a, b)                              # warm-up + correctness probe
t0 = time.perf_counter()
iters = 20
for _ in range(iters):
    R.mul(a, b)
dt = (time.perf_counter() - t0) / iters
print(f"{batch} kyber polymuls in {dt * 1e3:.2f} ms host to host "
      f"({batch / dt / 1e6:.2f} M/s, {R})")

# spot-check one row against the independent schoolbook oracle
assert np.array_equal(c[0], ref.schoolbook_negacyclic(a[0], b[0], q))
print("row 0 matches the schoolbook oracle")

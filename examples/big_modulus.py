"""62-bit-modulus negacyclic products, fully device-resident.

BigQPlan splits each operand into NTT-friendly ~29-bit RNS channels,
multiplies the channels in one stacked XLA graph, and reconstructs
mod q with the device-side Garner CRT — one XLA dispatch, two packed
int32 planes per operand across the host link.

Run:  python examples/big_modulus.py
"""

import numpy as np

from tpu_ntt import BigQPlan, find_params

p = find_params(4096, 62)
plan = BigQPlan(p)
print(f"n={p.n}  q={p.q} ({p.q.bit_length()} bits)  "
      f"channels={[hex(c) for c in plan.primes]}")

rng = np.random.default_rng(0)
a = rng.integers(0, p.q, (8, p.n)).astype(np.uint64)
b = rng.integers(0, p.q, (8, p.n)).astype(np.uint64)
c = plan.polymul(a, b)
print("c[0, :4] =", c[0, :4])

from tpu_ntt import ref
want = ref.schoolbook_negacyclic(a[0].astype(object), b[0].astype(object),
                                 p.q)
assert np.array_equal(c[0].astype(object), want.astype(object))
print("row 0 matches the schoolbook oracle")

"""Staged-buffer session — the v1 address-mapped host protocol analog.

The reference's FIRST host protocol (``NTT_PCIECommunication.c:73-78``,
superseded by the FIFO/SGDMA flows of v2-v4) DMA-writes operands into
FIXED device addresses on the address-mapped on-chip RAM and reads the
result back from a fixed address: no per-call device allocation, a
session-long device-side footprint, and the host round-trip is pure data
movement + one GO.

The accelerator twin of that discipline:

- **fixed shapes, one compile**: a session is constructed for one
  ``(batch, n)`` operand shape; its jitted product is compiled once at
  construction (the v1 "configure the RAM map" step) and every call
  afterwards is dispatch + transfer only.
- **explicit staging, reusable buffers**: ``stage`` puts an operand at
  a fixed device layout once; it can then feed any number of products
  (the address-mapped-RAM analog — operands live at their "address"
  across GOs).  ``multiply_device`` also accepts host arrays directly,
  folding the transfer into the dispatch.
- **device-resident results**: ``multiply_device`` returns the device
  handle without a d2h copy, so chained host logic can keep data on the
  accelerator the way v1 kept it in on-chip RAM between GOs.

``measure_overhead`` quantifies what the staging discipline buys: the
per-call wall-clock of the staged session vs the generic
``PolyMultEngine.multiply`` (fresh conversion + validation + transfer +
un-jitted dispatch path every call) at the same shape.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

__all__ = ["StagedSession"]


class StagedSession:
    """Fixed-shape, pre-compiled product session with explicit staging."""

    def __init__(self, engine: Any, batch: int):
        import jax
        import jax.numpy as jnp

        if engine.kind in ("sharded", "fourstep", "bigq"):
            raise NotImplementedError(
                f"StagedSession covers the single-chip engine kinds; "
                f"{engine.kind!r} stages through its own plan "
                f"(ShardedPlan.shard_coeffs / BigQPlan.polymul)")
        self.engine = engine
        self.batch = int(batch)
        self.n = engine.n
        self.q = engine.q
        plan = engine.plan

        # the plan's traced product body (np wrappers are jit-composable:
        # domain checks skip tracers, jnp.asarray is a no-op on them)
        if hasattr(plan, "polymul"):
            body = plan.polymul
        else:                          # pragma: no cover - all plans have it
            body = plan.polymul_jit

        # NO donation: donated operands are DELETED after the call,
        # which would crash the documented stage()-and-reuse and
        # device-resident chaining patterns on real hardware (r5 review
        # finding) — and for these kernels XLA reported the donated
        # buffers unusable anyway (layout mismatch), so donation bought
        # nothing.  The session's value is the fixed shape + the
        # compile-at-construction discipline.
        self._fn = jax.jit(lambda a, b: body(a, b))
        self._dtype = jnp.int32

        # compile NOW (the v1 "configure" step): calls never pay trace
        z = jnp.zeros((self.batch, self.n), self._dtype)
        self._fn_compiled = self._fn.lower(z, z).compile()

    # ------------------------------------------------------------------

    def _check(self, a) -> np.ndarray:
        a = np.asarray(a)
        if a.shape != (self.batch, self.n):
            raise ValueError(
                f"staged session is fixed at shape {(self.batch, self.n)}"
                f" (got {a.shape}); build a new session for a new shape")
        return a.astype(np.int64).astype(np.int32)

    def stage(self, a) -> Any:
        """EXPLICIT mode-1/2 staging: host array -> device buffer of the
        session's fixed shape (the DMA write into the mapped region).
        Optional — ``multiply_device`` folds the transfer into the GO
        dispatch; use ``stage`` when an operand is reused across calls
        (pay its transfer once, the on-chip-RAM posture)."""
        import jax
        return jax.device_put(self._check(a))

    def multiply_device(self, a, b):
        """Product as a DEVICE array (no d2h) — data stays resident for
        the next call, the on-chip-RAM-between-GOs posture.  Operands
        may be host arrays (transfer folds into the dispatch) or
        buffers from :meth:`stage` / previous results."""
        from ..validation import check_domain
        # opt-in only (no-op unless TPU_NTT_VALIDATE/set_validation):
        # validating a DEVICE-resident operand costs a d2h transfer, the
        # documented price of boundary validation
        check_domain(a, self.q, "staged multiply a")
        check_domain(b, self.q, "staged multiply b")
        a = a if not isinstance(a, np.ndarray) else self._check(a)
        b = b if not isinstance(b, np.ndarray) else self._check(b)
        return self._fn_compiled(a, b)

    def multiply(self, a, b) -> np.ndarray:
        """Host-to-host product (stage, GO, read back)."""
        return np.asarray(self.multiply_device(np.asarray(a),
                                               np.asarray(b)))

    # ------------------------------------------------------------------

    def measure_overhead(self, iters: int = 30) -> dict:
        """Per-call wall-clock: staged session vs the generic engine
        ``multiply`` at the same shape.  Returns microseconds per call
        and the ratio — the measured value of the v1 staging discipline
        (compile once, fixed shape vs convert+validate+dispatch per call;
        operands are not donated, so staged buffers stay reusable).
        """
        rng = np.random.default_rng(0)
        a = rng.integers(0, self.q, (self.batch, self.n))
        b = rng.integers(0, self.q, (self.batch, self.n))

        def timed(fn):
            fn()                                   # warm
            ts = []
            for _ in range(iters):
                t0 = time.perf_counter()
                np.asarray(fn())
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

        t_staged = timed(lambda: self.multiply(a, b))
        t_engine = timed(lambda: self.engine.multiply(a, b))
        return {"staged_us": round(t_staged * 1e6, 1),
                "engine_us": round(t_engine * 1e6, 1),
                "ratio": round(t_engine / t_staged, 3)
                if t_staged > 0 else float("inf"),
                "batch": self.batch, "n": self.n}

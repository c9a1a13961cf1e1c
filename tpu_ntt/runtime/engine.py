"""PolyMultEngine — the host application layer.

The accelerator re-expression of the reference's host flow
(``NTT_PCIECommunicationv2.c:109-224`` ``NTT_HARDWARE_EXE``):

=================================  =====================================
reference host step                engine equivalent
=================================  =====================================
PCIE_Open / dlopen driver          jax device discovery (+ optional
                                   native core load)
generate_params/generate_twiddles  plan construction (mode 0)
SendCommand(mode1/2) + DMA A, B    jax.device_put of the operands
SendCommand(3) + busy/done poll    one synchronous jitted call
PCIE_DmaFifoRead of C              device_get of the result
progressive loopback self-tests    :meth:`self_test` levels
(v3 PIO, v4 RAM/SGDMA tests)
=================================  =====================================

The engine also dispatches across backends (XLA plan, fused GPU kernel,
incomplete-NTT plan, big-q RNS plan, sharded plan) from a single
``multiply`` entry, as :func:`tpu_ntt.dispatch.build_plan` builds it —
the "one accelerator, many modes" role of the PolyMult FSM
(PolyMult.v:110-124).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np

__all__ = ["PolyMultEngine", "EngineReport"]


@dataclasses.dataclass
class EngineReport:
    """Self-test / run report (the printf protocol log analog)."""
    steps: list[tuple[str, bool, str]] = dataclasses.field(
        default_factory=list)

    def add(self, name: str, ok: bool, detail: str = ""):
        self.steps.append((name, ok, detail))

    @property
    def ok(self) -> bool:
        return all(s[1] for s in self.steps)

    def __str__(self):
        return "\n".join(f"[{'OK' if ok else 'FAIL'}] {name}"
                         + (f" — {d}" if d else "")
                         for name, ok, d in self.steps)


class PolyMultEngine:
    """High-level dispatcher over every transform backend."""

    def __init__(self, n: int = 256, q: int = 12289, mesh=None,
                 backend: str = "auto", negacyclic: bool = True):
        self.n, self.q = n, q
        self.mesh = mesh
        self.backend = backend
        self.negacyclic = negacyclic
        self._plan: Any = None
        self._kind = ""
        self._build()

    def _build(self):
        """Mode-0 analog: choose + build the plan (twiddle generation).

        The plan is :func:`tpu_ntt.dispatch.build_plan`'s.
        ``negacyclic=False`` selects Z_q[x]/(x^n - 1) — the HARDWARE's
        own product semantics (PolyMult.v:176-238 computes the cyclic
        product; no psi twist anywhere in the RTL flow).  A cyclic ring
        only needs omega of order n, so the structural requirement relaxes
        from q ≡ 1 (mod 2n) to q ≡ 1 (mod n)."""
        from ..dispatch import build_plan
        self._kind, self._plan = build_plan(self.n, self.q, self.negacyclic,
                                            self.mesh, self.backend)

    @property
    def kind(self) -> str:
        return self._kind

    @property
    def plan(self):
        return self._plan

    # ------------------------------------------------------------------

    def multiply(self, a, b) -> np.ndarray:
        """The full mode-1/2/3 + readback flow; host arrays in/out."""
        from ..validation import check_domain
        check_domain(a, self.q, "engine multiply a")
        check_domain(b, self.q, "engine multiply b")
        if self._kind == "bigq":
            return self._plan.polymul(np.asarray(a, dtype=np.uint64),
                                      np.asarray(b, dtype=np.uint64))
        if self._kind in ("sharded", "fourstep"):
            sp = self._plan
            a2 = np.atleast_2d(np.asarray(a))
            b2 = np.atleast_2d(np.asarray(b))
            rows = a2.shape[0]
            # a dp batch axis needs the batch divisible by its size:
            # zero-pad (zeros are valid ring elements) and slice after
            dp = sp.mesh.shape[sp.batch_axis] if sp.batch_axis else 1
            pad = (-rows) % dp
            if pad:
                z = np.zeros((pad, a2.shape[1]), dtype=a2.dtype)
                a2 = np.concatenate([a2, z])
                b2 = np.concatenate([b2, z])
            out = sp.unshard(sp.polymul_jit(sp.shard_coeffs(a2),
                                            sp.shard_coeffs(b2)))
            return out[:rows]
        a = np.asarray(a, dtype=np.int64).astype(np.int32)
        b = np.asarray(b, dtype=np.int64).astype(np.int32)
        return np.asarray(self._plan.polymul_jit(a, b))

    def multiply_robust(self, a, b, *, deadline_s: float = 300.0,
                        attempts: int = 3,
                        backoff_s: float = 5.0) -> np.ndarray:
        """``multiply`` with the failure detector wired in: each attempt
        runs under a :func:`~tpu_ntt.utils.watchdog.with_deadline` (the
        busy/done-polling-timeout analog,
        ``NTT_PCIECommunicationv2.c:56-103``) and wedged/failed attempts
        retry with backoff.  Raises
        :class:`~tpu_ntt.utils.watchdog.DeviceTimeout` (or the last
        error) after ``attempts`` failures — at which point the caller
        should checkpoint and restart the session, the reference's
        reboot-after-reprogram posture."""
        from ..utils.watchdog import retry
        return retry(lambda: self.multiply(a, b), attempts=attempts,
                     timeout_s=deadline_s, backoff_s=backoff_s)

    def multiply_batch(self, directory, a, b, *, chunk: int = 4096,
                       deadline_s: float = 300.0,
                       attempts: int = 3) -> np.ndarray:
        """Restartable batch multiply: chunks stream through
        ``multiply_robust`` and completed chunks persist via
        :class:`~tpu_ntt.utils.checkpoint.CheckpointedRun`, so a crashed
        or wedged job resumes from the last complete chunk instead of
        restarting (SURVEY.md §5 checkpoint/resume + failure detection,
        wired together at the engine level)."""
        import hashlib

        from ..utils.checkpoint import CheckpointedRun
        a = np.atleast_2d(a)
        b = np.atleast_2d(b)
        if a.shape != b.shape:
            raise ValueError("operand batches must have the same shape")
        # bind the checkpoint directory to THESE inputs and params:
        # resuming with different data of the same shape must fail loudly
        # instead of mixing stale chunks into the result
        h = hashlib.sha256()
        h.update(f"n={self.n} q={self.q}".encode())
        h.update(np.ascontiguousarray(a))
        h.update(np.ascontiguousarray(b))
        run = CheckpointedRun(directory, total=a.shape[0], chunk=chunk,
                              fingerprint=h.hexdigest())
        for lo, hi in run.pending():
            run.complete(lo, hi, self.multiply_robust(
                a[lo:hi], b[lo:hi], deadline_s=deadline_s,
                attempts=attempts))
        return run.gather()

    # ------------------------------------------------------------------

    def self_test(self, verbose: bool = False) -> EngineReport:
        """Progressive bring-up, mirroring the reference's loopback ladder
        (v3 PIO loopback -> v4 RAM r/w -> v4 SGDMA loopback -> real flow
        with known vectors, NTT_PCIEComunicationv4.c:317-466, v2:231-238).
        """
        import jax
        rep = EngineReport()
        t0 = time.time()

        # 1. device transfer loopback (the RAM write/read-back test)
        x = np.arange(max(16, self.n), dtype=np.int32) % 251
        back = np.asarray(jax.device_put(x))
        rep.add("device loopback", np.array_equal(back, x),
                f"{x.nbytes} bytes h2d+d2h")

        # 2. transform round-trip (engine-level NTT sanity,
        #    test_generator.py:157-170 analog)
        if self._kind in ("xla", "fused", "sharded", "fourstep"):
            from ..transform import Plan
            from ..params import make_params
            plan = self._plan if self._kind == "xla" else Plan(
                make_params(self.n, self.q, negacyclic=self.negacyclic))
            rng = np.random.default_rng(0)
            v = rng.integers(0, self.q, (2, self.n)).astype(np.int32)
            f = plan.forward_jit(v)
            g = np.asarray(plan.inverse_jit(f))
            fix = plan.arith.pointwise_fix
            if fix != 1:
                g = (g.astype(np.int64) * pow(fix, -1, self.q)) % self.q
            rep.add("ntt/intt round-trip", np.array_equal(g, v))

        # 3. known small product — the RTL testbench vector
        #    (1+2x+3x^2)(2+2x) = 2+6x+10x^2+6x^3 (NTT_PolyMul_test.v:165-196)
        #    deg(a)+deg(b) < n, so cyclic and negacyclic rings agree —
        #    exactly the regime the hardware flow is exact in (SURVEY §0)
        a = np.zeros(self.n, dtype=np.int64)
        b = np.zeros(self.n, dtype=np.int64)
        a[:3] = [1, 2, 3]
        b[:2] = [2, 2]
        c = np.asarray(self.multiply(a[None], b[None]))[0]
        ok = (list(c[:4].astype(np.int64)) == [2, 6, 10, 6]
              and not c[4:].any())
        rep.add("known product vector", bool(ok), "(1+2x+3x²)(2+2x)")

        # 4. random product vs independent oracle
        from .. import ref
        rng = np.random.default_rng(1)
        ra = rng.integers(0, self.q, self.n, dtype=np.uint64)
        rb = rng.integers(0, self.q, self.n, dtype=np.uint64)
        rc = np.asarray(self.multiply(ra[None], rb[None]))[0]
        oracle = (ref.schoolbook_negacyclic if self.negacyclic
                  else ref.schoolbook_cyclic)
        want = oracle(ra.astype(object), rb.astype(object), self.q)
        rep.add("random product vs schoolbook",
                bool(np.array_equal(rc.astype(object), want.astype(object))),
                f"total {time.time() - t0:.2f}s, backend={self._kind}")
        if verbose:
            print(rep)
        return rep

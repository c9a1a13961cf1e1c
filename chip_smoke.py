"""Proof that tpu-ntt runs its main path on one GPU.

    python chip_smoke.py              # every benchmark family on one GPU
    python chip_smoke.py --four       # the sharded path on four GPUs
    python chip_smoke.py --rehearse   # the same phases, tiny, on the CPU

Every family of the benchmark (``bench.SWEEP``) is built through the
public entry points at the benchmark's widths and batches, and the
products of its whole batch are compared exactly (these are integers: no
tolerance) with an independent reference: ``ref.schoolbook_rows`` for
n = 256, the native uint64 NTT of ``csrc`` for the large rings and big q.
Then the engine's self-test, the CLI's ``selftest``, a ``StagedSession``
and the matmul backend run, and the fused kernel (``ops/fused.py``) is compared with the XLA
plan and timed against it, taking turns.  Each phase prints its set-up
seconds (compilation included) and the device's ``peak_bytes_in_use``.

``--four`` runs only the sharded path on four cards, each result compared
with the one-card result on the same inputs: xlarge through a 1-D ``"x"``
mesh, bigq1m through ``BigQPlan(mesh=...)``, the (dp=2, sp=2) mesh, and a
timing of the 1-D exchange against the hierarchical 2x2 one.

Without a GPU (and without ``--rehearse``) the script exits non-zero and
prints no result.  Any failing phase makes it exit non-zero.  On success
the last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def log(*a):
    print(*a, flush=True)


def _turns(fns: dict, args: dict, iters: int) -> dict:
    """Median seconds of each zero-argument-ready fn, in turns
    a, b, b, a so drift hits both alike."""
    import jax
    import numpy as np
    names = list(fns)
    order = names + names[::-1]
    ts = {k: [] for k in names}
    for k in names:                                   # compile + warm
        jax.block_until_ready(fns[k](*args[k]))
    for k in order:
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fns[k](*args[k]))
            ts[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) for k, v in ts.items()}


def _kernels(fn, *args) -> int:
    """Kernels in XLA's compiled ``fn(*args)`` (see :func:`count_kernels`)."""
    import jax
    return count_kernels(jax.jit(fn).lower(*args).compile().as_text())


def count_kernels(hlo: str) -> int:
    """The fusions and custom calls of every computation of an optimized
    HLO module that is not itself a fusion body."""
    import re
    count, inside = 0, False
    for line in hlo.splitlines():
        head = re.match(r"(ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head and not line.startswith(" "):
            inside = not head.group(2).startswith("fused")
        elif inside and re.search(r"\s(fusion|custom-call)\(", line):
            count += 1
    return count


class Smoke:
    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.failures = []

    def phase(self, name, fn, *a):
        import bench
        t0 = time.perf_counter()
        try:
            detail = fn(*a) or ""
        except Exception:                             # report, keep going
            self.failures.append(name)
            log(f"[FAIL] {name}")
            traceback.print_exc()
            return
        log(f"[ok] {name}: {detail} setup_s={time.perf_counter() - t0:.2f}"
            f" peak_bytes_in_use={bench.peak_bytes()}")

    def batch(self, batch: int) -> int:
        return min(batch, 4) if self.rehearse else batch

    # -- one GPU -----------------------------------------------------------

    def family(self, config: str, batch: int):
        """Build the cell through the engine, compile and run its device
        step, and check the served path's whole batch exactly."""
        import jax

        import bench
        cell = bench.build_cell(config, self.batch(batch),
                                rehearse=self.rehearse)
        t0 = time.perf_counter()
        step = jax.jit(cell.step).lower(*cell.state).compile()
        compile_s = time.perf_counter() - t0
        jax.block_until_ready(step(*cell.state))
        cell.check()
        return (f"kind={cell.kind} n={cell.n} q={cell.q} "
                f"batch={cell.batch} exact compile_s={compile_s:.2f}")

    def engine(self):
        from tpu_ntt.runtime.engine import PolyMultEngine
        kinds = []
        for n, q in ((256, 12289), (256, 3329), (256, 8380417),
                     (4096, 0xFFFFFFFF00000001)):
            eng = PolyMultEngine(n, q)
            rep = eng.self_test()
            if not rep.ok:
                raise AssertionError(f"self_test n={n} q={q}:\n{rep}")
            kinds.append(eng.kind)
        return f"self_test ok for {kinds}"

    def cli(self):
        from tpu_ntt.cli import main
        rc = main(["selftest"])
        if rc != 0:
            raise AssertionError(f"python -m tpu_ntt selftest exited {rc}")
        return "python -m tpu_ntt selftest: 0"

    def staged(self):
        import numpy as np

        from tpu_ntt.runtime.engine import PolyMultEngine
        from tpu_ntt.runtime.staged import StagedSession
        eng = PolyMultEngine(256, 12289)
        batch = self.batch(8192)
        sess = StagedSession(eng, batch=batch)
        rng = np.random.default_rng(3)
        a = rng.integers(0, 12289, (batch, 256))
        b = rng.integers(0, 12289, (batch, 256))
        x = sess.stage(a)
        got = np.asarray(sess.multiply_device(x, sess.stage(b)))
        again = np.asarray(sess.multiply_device(x, sess.stage(a)))
        if not (np.array_equal(got, eng.multiply(a, b))
                and np.array_equal(again, eng.multiply(a, a))):
            raise AssertionError("StagedSession differs from the engine")
        return f"kind={eng.kind} batch={batch} exact, staged buffer reused"

    def matmul(self):
        """backend="matmul" (bf16 limbs, f32 accumulation) is exact on
        this device: a whole sw256 batch against the reference."""
        import numpy as np

        from tpu_ntt import ref
        from tpu_ntt.runtime.engine import PolyMultEngine
        eng = PolyMultEngine(256, 12289, backend="matmul")
        batch = self.batch(8192)
        rng = np.random.default_rng(9)
        a = rng.integers(0, 12289, (batch, 256))
        b = rng.integers(0, 12289, (batch, 256))
        a[0] = b[0] = 12288
        if not np.array_equal(eng.multiply(a, b),
                              ref.schoolbook_rows(a, b, 12289)):
            raise AssertionError("matmul backend is not exact")
        return f"kind={eng.kind} batch={batch} exact"

    def kernel(self, config: str, batch: int):
        """The fused kernel against the XLA plan: exact at the cell's
        batch, then both timed in turns (chained products per dispatch)."""
        import jax.numpy as jnp
        import numpy as np

        import bench
        from tpu_ntt.ops.fused import FusedPolymul
        from tpu_ntt.params import make_params, preset
        from tpu_ntt.schemes import IncompletePlan
        from tpu_ntt.transform import Plan

        batch = self.batch(batch)
        rng = np.random.default_rng(4)
        if config.startswith("kyber"):
            plan = IncompletePlan(256, 3329, levels=1)
            q, xla_mul, xla_mv = 3329, plan.polymul, plan.matvec
        else:
            base = preset("dilithium256" if config == "dilithium_matvec"
                          else config.removesuffix("cyc"))
            plan = Plan(make_params(base.n, base.q,
                                    negacyclic=not config.endswith("cyc")))
            q, xla_mul, xla_mv = base.q, plan.polymul, plan.matvec
        k = FusedPolymul(plan, interpret=self.rehearse)
        if config.endswith("_matvec"):
            r = 3 if config.startswith("kyber") else 4
            s = jnp.asarray(rng.integers(0, q, (batch, r, 256)), jnp.int32)
            A = jnp.asarray(rng.integers(0, q, (batch, r, r, 256)),
                            jnp.int32)
            fns = {"xla": lambda A_, s_: (A_, xla_mv(A_, s_)),
                   "fused": lambda A_, s_: (A_, k.matvec(A_, s_))}
            state = (A, s)
        else:
            a = rng.integers(0, q, (batch, 256))
            a[0] = q - 1
            state = (jnp.asarray(a, jnp.int32),
                     jnp.asarray(rng.integers(0, q, (batch, 256)),
                                 jnp.int32))
            fns = {"xla": lambda x, y: (xla_mul(x, y), x),
                   "fused": lambda x, y: (k.polymul(x, y), x)}
        outs = {nm: np.asarray(bench.chained(f, 1)(*state)[1 if
                               config.endswith("_matvec") else 0])
                for nm, f in fns.items()}
        if not np.array_equal(outs["xla"], outs["fused"]):
            raise AssertionError(f"fused kernel differs from XLA ({config})")
        # kernels per product (per module product for _matvec), and per
        # forward transform of the XLA plan
        kernels = {nm: _kernels(f, *state) for nm, f in fns.items()}
        kernels["xla_forward"] = _kernels(plan.forward, state[0])
        inner, iters = (1, 1) if self.rehearse else (16, 10)
        t = _turns({nm: bench.chained(f, inner) for nm, f in fns.items()},
                   {nm: state for nm in fns}, iters)
        per = {nm: t[nm] / inner * 1e6 for nm in t}
        return (f"batch={batch} exact vs XLA; per chained product "
                f"xla_us={per['xla']:.1f} fused_us={per['fused']:.1f} "
                f"speedup={per['xla'] / per['fused']:.2f}; kernels "
                f"xla={kernels['xla']} fused={kernels['fused']} "
                f"xla_forward={kernels['xla_forward']}")

    # -- four GPUs -----------------------------------------------------------

    def _ring(self, n: int, bits: int):
        from tpu_ntt.params import find_params
        return find_params(min(n, 1 << 14) if self.rehearse else n, bits)

    def four_xlarge(self):
        import numpy as np

        from tpu_ntt.parallel.sharded import make_mesh
        from tpu_ntt.runtime.engine import PolyMultEngine
        p = self._ring(1 << 20, 28)
        rng = np.random.default_rng(5)
        a = rng.integers(0, p.q, (4, p.n))
        b = rng.integers(0, p.q, (4, p.n))
        one = PolyMultEngine(p.n, p.q)
        four = PolyMultEngine(p.n, p.q, mesh=make_mesh(4))
        if not np.array_equal(one.multiply(a, b), four.multiply(a, b)):
            raise AssertionError("xlarge: 4-card result differs")
        return (f"n={p.n} q={p.q} batch=4 {four.kind} mesh "
                f"{dict(four.mesh.shape)} == 1-card {one.kind}")

    def four_bigq(self):
        import numpy as np

        from tpu_ntt.parallel.sharded import make_mesh
        from tpu_ntt.runtime.engine import PolyMultEngine
        p = self._ring(1 << 20, 62)
        rng = np.random.default_rng(6)
        a = rng.integers(0, p.q, (2, p.n), dtype=np.uint64)
        b = rng.integers(0, p.q, (2, p.n), dtype=np.uint64)
        one = PolyMultEngine(p.n, p.q)
        four = PolyMultEngine(p.n, p.q, mesh=make_mesh(4))
        if not np.array_equal(one.multiply(a, b), four.multiply(a, b)):
            raise AssertionError("bigq1m: 4-card result differs")
        return (f"n={p.n} q={p.q} batch=2 BigQPlan(mesh 4) == 1-card, "
                f"{len(four.plan.primes)} channels")

    def four_dp_sp(self):
        import jax
        import numpy as np
        from jax.sharding import Mesh

        from tpu_ntt.runtime.engine import PolyMultEngine
        p = self._ring(1 << 20, 28)
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
        rng = np.random.default_rng(7)
        a = rng.integers(0, p.q, (4, p.n))
        b = rng.integers(0, p.q, (4, p.n))
        one = PolyMultEngine(p.n, p.q)
        four = PolyMultEngine(p.n, p.q, mesh=mesh)
        if not np.array_equal(one.multiply(a, b), four.multiply(a, b)):
            raise AssertionError("(dp=2, sp=2): 4-card result differs")
        return f"n={p.n} batch=4 mesh (dp=2, sp=2) == 1-card"

    def four_exchange(self):
        """1-D all_to_all over 4 cards against the hierarchical 2x2
        exchange, same ring and inputs, in turns."""
        import numpy as np

        import bench
        from tpu_ntt.parallel.sharded import (ShardedPlan, make_mesh,
                                              make_mesh_hier)
        p = self._ring(1 << 20, 28)
        plans = {"1d": ShardedPlan(p, make_mesh(4)),
                 "hier2x2": ShardedPlan(p, make_mesh_hier(2, 2),
                                        axis=("sp1", "sp2"))}
        rng = np.random.default_rng(8)
        a = rng.integers(0, p.q, (4, p.n))
        b = rng.integers(0, p.q, (4, p.n))
        state = {k: (pl.shard_coeffs(a), pl.shard_coeffs(b))
                 for k, pl in plans.items()}
        outs = {k: pl.unshard(pl.polymul_jit(*state[k]))
                for k, pl in plans.items()}
        if not np.array_equal(outs["1d"], outs["hier2x2"]):
            raise AssertionError("hierarchical exchange differs from 1-D")
        inner, iters = (1, 1) if self.rehearse else (8, 10)
        fns = {k: bench.chained(lambda x, y, pl=pl: (pl.polymul_jit(x, y),
                                                     x), inner)
               for k, pl in plans.items()}
        t = _turns(fns, state, iters)
        return (f"n={p.n} batch=4 per chained product "
                f"1d_ms={t['1d'] / inner * 1e3:.3f} "
                f"hier2x2_ms={t['hier2x2'] / inner * 1e3:.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the phases at tiny sizes on the CPU")
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four devices")
    args = ap.parse_args(argv)
    try:
        import bench
        from tpu_ntt.utils.jaxcache import enable_compile_cache
        from tpu_ntt.utils.profiling import device_info
    except ImportError as e:
        print(f"chip_smoke.py runs from the root of a tpu-ntt checkout "
              f"({e})", file=sys.stderr)
        return 2

    info = device_info()
    want = 4 if args.four else 1
    if not args.rehearse and info["platform"] != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's platform is "
              f"{info['platform']!r} (use --rehearse on the CPU)",
              file=sys.stderr)
        return 2
    if info["count"] < want:
        print(f"need {want} devices, JAX found {info['count']}",
              file=sys.stderr)
        return 2
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    if "nvidia_smi" in info:
        log(info["nvidia_smi"])
    enable_compile_cache()

    smoke = Smoke(args.rehearse)
    if args.four:
        for name in ("xlarge", "bigq", "dp_sp", "exchange"):
            smoke.phase(f"four/{name}", getattr(smoke, f"four_{name}"))
    else:
        for config, batch, _ in bench.SWEEP:
            smoke.phase(f"family/{config}", smoke.family, config, batch)
        smoke.phase("engine/self_test", smoke.engine)
        smoke.phase("cli/selftest", smoke.cli)
        smoke.phase("staged_session", smoke.staged)
        smoke.phase("matmul/sw256", smoke.matmul)
        for config, batch in (("sw256", 8192), ("hw256cyc", 8192),
                              ("dilithium256", 8192), ("kyber", 8192),
                              ("kyber_matvec", 2048),
                              ("dilithium_matvec", 1024)):
            smoke.phase(f"kernel/{config}", smoke.kernel, config, batch)
    if smoke.failures:
        print(f"chip_smoke.py: {len(smoke.failures)} phase(s) failed: "
              f"{', '.join(smoke.failures)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        k: info[k] for k in ("platform", "kind", "count")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

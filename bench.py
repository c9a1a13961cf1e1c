"""Benchmark harness — the time_testing256.c analog, on one GPU.

Methodology mirrors the reference harness (NTT_Software_Evaluations/
NTT-256/time_testing256.c:144-187): warm-up, then a fixed number of timed
iterations, each ending in ``block_until_ready``, median wall clock — over
batched device-resident arrays, ``inner`` products chained on the device
per dispatch.  Every cell is built through the public entry points
(``PolyMultEngine`` and its plan), so it runs the plan the platform rule
(``tpu_ntt.dispatch.select_plan``) picks, and every cell checks the
products of its whole batch exactly against an independent reference.

Prints ONE JSON line to stdout:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
     "device": {"platform", "kind", "count", "name", "power_limit", ...}}
``--sweep`` first prints one JSON row per cell to stderr.  Exits non-zero
unless JAX's platform is ``gpu``, and on any failing cell.

vs_baseline: the reference FPGA's butterfly speed-of-light is
PE × f_clk = 8 butterflies/cycle × 50 MHz = 4.0e8 butterflies/s
(defines.v:27 PE_NUMBER=8; DE2i-150 50 MHz board clock — generous, since
the design's restricted Fmax is 18.29 MHz per nttParametric.sta.rpt).
vs_baseline is butterflies/s on one device divided by that number.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable

import numpy as np

FPGA_BUTTERFLIES_PER_SEC = 8 * 50e6          # PE x board clock (generous)

# (config, batch, inner): the 14 cells.  inner chains products on the
# device so one dispatch does enough work to time.
SWEEP = [("sw256", 8192, 64), ("bigq62", 256, 8), ("bigq64", 256, 8),
         ("bigq65536", 16, 8), ("bigq1m", 2, 4), ("kyber", 8192, 64),
         ("dilithium256", 8192, 64), ("large", 16, 16), ("large23", 16, 16),
         ("xlarge", 4, 8), ("hw256", 8192, 64), ("hw256cyc", 8192, 64),
         ("kyber_matvec", 2048, 16), ("dilithium_matvec", 1024, 16)]
CELLS = {c: (b, i) for c, b, i in SWEEP}

# ring of each non-preset cell: (n, q or bits); the 62-bit moduli come from
# find_params, "goldilocks" is 2^64 - 2^32 + 1
_RINGS = {"large": (1 << 16, 28), "large23": (1 << 16, 7340033),
          "xlarge": (1 << 20, 28), "bigq62": (4096, 62),
          "bigq64": (4096, 0xFFFFFFFF00000001), "bigq65536": (1 << 16, 62),
          "bigq1m": (1 << 20, 62)}
# the smaller rings of ``--rehearse``: same plan kinds, CPU-sized
_REHEARSE_N = {1 << 16: 1 << 14, 1 << 20: 1 << 14}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Cell:
    """One benchmark cell: a device ``step`` to chain, its device
    ``state``, and an exact check of the served path."""
    config: str
    n: int
    q: int
    batch: int
    kind: str                        # the engine's plan kind
    step: Callable                   # state -> state (one product each row)
    state: tuple
    butterflies: int                 # per step
    check: Callable[[], None]        # raises AssertionError on a mismatch


def _params(config: str, rehearse: bool):
    from tpu_ntt.params import find_params, make_params, preset
    if config in _RINGS:
        n, qb = _RINGS[config]
        if rehearse:
            n = _REHEARSE_N.get(n, n)
        return (make_params(n, qb) if qb > 64 else find_params(n, qb))
    if config.endswith("cyc"):
        base = preset(config[:-3])
        return make_params(base.n, base.q, negacyclic=False)
    if config == "kyber":
        return None
    return preset(config)


def _operands(rng, q, shape):
    """Uniform operands with the first row at q - 1 (the range edge)."""
    a = rng.integers(0, q, shape, dtype=np.uint64)
    b = rng.integers(0, q, shape, dtype=np.uint64)
    a[(0,) * (len(shape) - 1)] = q - 1
    b[(0,) * (len(shape) - 1)] = q - 1
    return a, b


def _native_oracle(a, b, p):
    """Row-wise negacyclic products by the native uint64 NTT (csrc)."""
    from tpu_ntt.runtime.native import load
    core = load()
    if core is None:
        raise RuntimeError("the native uint64 oracle (csrc) did not build")
    return np.stack([core.polymul64(x, y, p.q, p.psi)
                     for x, y in zip(a, b)])


def _expect_equal(got, want, what):
    got = np.asarray(got).astype(np.uint64)
    want = np.asarray(want).astype(np.uint64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.argwhere(got != want) if got.shape == want.shape else []
        raise AssertionError(
            f"{what}: {len(bad)} coefficients differ from the reference"
            f" (first at {bad[0].tolist() if len(bad) else got.shape})")


def build_cell(config: str, batch: int, rng=None,
               rehearse: bool = False) -> Cell:
    """The cell ``config`` at ``batch``, built through the engine."""
    import jax.numpy as jnp

    from tpu_ntt import ref
    from tpu_ntt.runtime.engine import PolyMultEngine

    rng = rng if rng is not None else np.random.default_rng(0)
    if config.endswith("_matvec"):
        n, q, r = (256, 3329, 3) if config == "kyber_matvec" \
            else (256, 8380417, 4)
        eng = PolyMultEngine(n, q)
        plan = eng.plan
        A, s = _operands(rng, q, (batch, r, r, n))
        A, s = A.astype(np.int32), s[:, :, 0].astype(np.int32)

        def check():
            got = np.asarray(plan.matvec_jit(A, s))
            want = sum(ref.schoolbook_rows(A[:, :, j], s[:, None, j], q)
                       for j in range(r)) % q
            _expect_equal(got, want, config)

        return Cell(config, n, q, batch, eng.kind,
                    lambda A_, s_: (A_, plan.matvec(A_, s_)),
                    (jnp.asarray(A), jnp.asarray(s)),
                    batch * r * (r + 2) * (n // 2) * 8, check)

    p = _params(config, rehearse)
    n, q = (256, 3329) if p is None else (p.n, p.q)
    negacyclic = p is None or p.negacyclic
    eng = PolyMultEngine(n, q, negacyclic=negacyclic)
    plan = eng.plan
    a, b = _operands(rng, q, (batch, n))
    # kyber: two 128-point transforms of 7 stages per operand (levels=1)
    bf = batch * 3 * (n // 2) * (7 if p is None else p.log2n)

    if eng.kind == "bigq":
        def check():
            _expect_equal(eng.multiply(a, b), _native_oracle(a, b, p),
                          config)

        return Cell(config, n, q, batch, eng.kind,
                    lambda la, ha, lb, hb: (*plan.polymul_planes(
                        la, ha, lb, hb), la, ha),
                    (*plan.device_planes(a), *plan.device_planes(b)),
                    bf * len(plan.primes), check)

    a, b = a.astype(np.int32), b.astype(np.int32)
    if eng.kind == "fourstep":
        def check():
            _expect_equal(eng.multiply(a, b), _native_oracle(a, b, p),
                          config)

        return Cell(config, n, q, batch, eng.kind,
                    lambda x, y: (plan.polymul_jit(x, y), x),
                    (plan.shard_coeffs(a), plan.shard_coeffs(b)),
                    bf, check)

    def check():
        _expect_equal(eng.multiply(a, b),
                      ref.schoolbook_rows(a, b, q, negacyclic), config)

    return Cell(config, n, q, batch, eng.kind,
                lambda x, y: (plan.polymul(x, y), x),
                (jnp.asarray(a), jnp.asarray(b)), bf, check)


def chained(step, inner: int):
    """One jitted dispatch that applies ``step`` ``inner`` times, each
    output feeding the next input (outputs are canonical ring elements,
    so the chain stays in the ring)."""
    import jax

    def run(*state):
        return jax.lax.fori_loop(0, inner, lambda _, s: step(*s), state)

    return jax.jit(run)


def peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_cell(cell: Cell, inner: int, iters: int, warmup: int) -> dict:
    """Time ``inner`` chained steps per dispatch, then check the cell."""
    import jax
    fn = chained(cell.step, inner)
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*cell.state))
    setup_s = time.perf_counter() - t0
    for _ in range(warmup):
        jax.block_until_ready(fn(*cell.state))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*cell.state))
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    cell.check()
    return {"config": cell.config, "n": cell.n, "q": int(cell.q),
            "batch": cell.batch, "inner": inner, "kind": cell.kind,
            "setup_s": setup_s, "median_ms": med * 1e3,
            "polymuls_per_s": inner * cell.batch / med,
            "gbutterflies_per_s": inner * cell.butterflies / med / 1e9,
            "peak_bytes_in_use": peak_bytes()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="sw256", choices=sorted(CELLS))
    ap.add_argument("--batch", type=int, default=None,
                    help="default: the cell's batch in SWEEP")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--inner", type=int, default=None,
                    help="products chained per dispatch (default: SWEEP)")
    ap.add_argument("--sweep", action="store_true",
                    help="run every cell first; rows to stderr")
    ap.add_argument("--only", default=None,
                    help="comma-separated cells for --sweep")
    args = ap.parse_args(argv)

    from tpu_ntt.utils.jaxcache import enable_compile_cache
    from tpu_ntt.utils.profiling import device_info
    device = device_info()
    if device["platform"] != "gpu":
        log(f"bench.py measures a GPU; JAX's platform is "
            f"{device['platform']!r}")
        return 2
    enable_compile_cache()
    log(f"[bench] {device}")

    if args.sweep:
        only = set(args.only.split(",")) if args.only else None
        for cfg, batch, inner in SWEEP:
            if only is None or cfg in only:
                row = run_cell(build_cell(cfg, batch), inner,
                               max(5, args.iters // 3), args.warmup)
                log(json.dumps({**row, "device": device}))

    batch, inner = CELLS[args.config]
    row = run_cell(build_cell(args.config, args.batch or batch),
                   args.inner or inner, args.iters, args.warmup)
    bf_per_s = row["gbutterflies_per_s"] * 1e9
    cyc = "cyclic" if args.config.endswith("cyc") else "negacyclic"
    print(json.dumps({
        "metric": f"ntt_butterflies_per_sec_per_device ({args.config} {cyc}"
                  f" polymul, batch={row['batch']})",
        "value": round(bf_per_s / 1e9, 3),
        "unit": "Gbutterflies/s",
        "vs_baseline": round(bf_per_s / FPGA_BUTTERFLIES_PER_SEC, 1),
        **{k: row[k] for k in ("polymuls_per_s", "median_ms", "setup_s",
                               "kind", "peak_bytes_in_use")},
        "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Profiling and roofline accounting.

The reference's observability is wall-clock timing around whole products
(``time_testing256.c:144-187``, host-side HW timing in
``NTT_PCIECommunicationv2.c:162-229``) plus static Quartus timing reports.
Here: the same warm-up + N-run methodology as a reusable timer, a
jax.profiler trace hook (the accelerator equivalent of a ModelSim
waveform), and a roofline model that plays the role of the Fmax/resource
reports — how close a measured run is to the device's published compute
and bandwidth peaks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time

import numpy as np

__all__ = ["Timer", "time_fn", "trace", "polymul_roofline", "RooflineReport",
           "PEAKS", "device_peaks", "device_info"]

# Published peaks per device, keyed by ``jax.Device.device_kind``.  A
# device that is not here is an error, never a default.
#   hbm_bytes_per_s: NVIDIA H100 SXM data sheet, 3.35 TB/s.
#   int32_ops_per_s: 132 SMs x 64 INT32 lanes (Hopper architecture white
#     paper) x 1.98 GHz boost clock — the same clock as the data sheet's
#     67 TFLOP/s float32 (132 x 128 FP32 lanes x 2 x 1.98 GHz).
# Both assume the card's full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "int32_ops_per_s": 132 * 64 * 1.98e9},
}


def device_peaks(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; KeyError if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def device_info() -> dict:
    """The devices JAX reports (``platform``, ``kind``, ``count``) and,
    on a GPU, the card's ``name`` and ``power_limit`` as ``nvidia-smi``
    gives them (a card below its maximum limit runs slower under load,
    so every number names the limit it was taken at)."""
    import jax
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] == "gpu":
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        info["nvidia_smi"] = out.strip().splitlines()[0]
        info["name"], info["power_limit"] = (
            f.strip() for f in info["nvidia_smi"].split(",", 1))
    return info


class Timer:
    """Warm-up + repeated timing with per-call device sync
    (time_testing256.c methodology)."""

    def __init__(self, warmup: int = 3, iters: int = 30):
        self.warmup, self.iters = warmup, iters

    def run(self, fn) -> dict:
        r = None
        for _ in range(self.warmup):
            r = fn()
        _block(r)
        ts = []
        for _ in range(self.iters):
            t0 = time.perf_counter()
            r = fn()
            _block(r)
            ts.append(time.perf_counter() - t0)
        ts = np.array(ts)
        return {"mean_s": float(ts.mean()), "min_s": float(ts.min()),
                "p50_s": float(np.median(ts)), "std_s": float(ts.std()),
                "iters": self.iters}


def _block(r):
    if hasattr(r, "block_until_ready"):
        r.block_until_ready()
    elif isinstance(r, (list, tuple)):
        for x in r:
            _block(x)


def time_fn(fn, warmup: int = 3, iters: int = 30) -> dict:
    return Timer(warmup, iters).run(fn)


@contextlib.contextmanager
def trace(out_dir: str):
    """jax.profiler trace context — view with TensorBoard/XProf."""
    import jax
    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class RooflineReport:
    butterflies: int
    measured_s: float
    ops_per_butterfly: float
    int_ops_ceiling: float
    hbm_bytes: int
    hbm_ceiling: float

    @property
    def butterflies_per_s(self) -> float:
        return self.butterflies / self.measured_s

    @property
    def compute_bound_s(self) -> float:
        return self.butterflies * self.ops_per_butterfly / self.int_ops_ceiling

    @property
    def memory_bound_s(self) -> float:
        return self.hbm_bytes / self.hbm_ceiling

    @property
    def roofline_s(self) -> float:
        return max(self.compute_bound_s, self.memory_bound_s)

    @property
    def bound(self) -> str:
        return ("compute" if self.compute_bound_s >= self.memory_bound_s
                else "HBM")

    @property
    def roofline_fraction(self) -> float:
        """Measured throughput as a fraction of the model's bound."""
        return self.roofline_s / self.measured_s

    def __str__(self):
        return (f"{self.butterflies_per_s / 1e9:.1f} G butterflies/s — "
                f"{100 * self.roofline_fraction:.0f}% of {self.bound}-bound "
                f"roofline ({self.roofline_s * 1e6:.1f} µs bound vs "
                f"{self.measured_s * 1e6:.1f} µs measured)")


def polymul_roofline(params, batch: int, measured_s: float,
                     device_kind: str,
                     ops_per_butterfly: float = 20.0) -> RooflineReport:
    """Roofline for one batched polymul call (2 fwd + 1 inv transform,
    3 arrays of HBM traffic) against the published peaks of
    ``device_kind`` (:data:`PEAKS`; KeyError for an unknown device).

    ``ops_per_butterfly``: int32 operations of one butterfly, counted
    from ops/modmul — about 20 for Shoup (one constant multiply, an add,
    a subtract, their conditional corrections)."""
    peaks = device_peaks(device_kind)
    bf = 3 * batch * (params.n // 2) * params.log2n
    traffic = 3 * batch * params.n * 4          # a, b in; c out
    return RooflineReport(bf, measured_s, ops_per_butterfly,
                          peaks["int32_ops_per_s"], traffic,
                          peaks["hbm_bytes_per_s"])

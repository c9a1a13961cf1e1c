"""The platform rule: which plan serves a ring on this machine.

:func:`select_plan` names the plan kind and :func:`build_plan` builds it.
Every entry point that builds a plan (``PolyMultEngine``, ``Ring``,
``kyber_plan``, ``auto_plan``, the benchmark) goes through
:func:`build_plan`; no other module looks at the platform.  The rule knows
two platforms:

- ``"gpu"``: the fused Pallas kernel (:mod:`tpu_ntt.ops.fused`) for the
  rings it covers, XLA plans for the rest;
- ``"cpu"``: XLA plans only (tests and the rehearsal of chip runs).

Any other platform raises.

Plan kinds:

=====================  ==================================================
``"fused"``            ops.fused.FusedPolymul over a full-NTT Plan
``"fused-incomplete"`` ops.fused.FusedPolymul over an IncompletePlan
``"xla"``              transform.Plan
``"incomplete"``       schemes.IncompletePlan (no full NTT mod q)
``"fourstep"``         parallel.sharded.ShardedPlan on a one-device mesh
                       (n > FOURSTEP_MIN_N)
``"sharded"``          parallel.sharded.ShardedPlan over the given mesh
``"bigq"``             bigq.BigQPlan (q of 30..64 bits, RNS channels)
``"matmul"``           ops.matmul_ntt.MatmulNTT (explicit only)
=====================  ==================================================
"""

from __future__ import annotations

__all__ = ["PLATFORMS", "BACKENDS", "current_platform", "select_plan",
           "build_plan"]

PLATFORMS = ("gpu", "cpu")
BACKENDS = ("auto", "xla", "pallas", "matmul")
# rings past this size run the four-step plan: a flat stage-by-stage graph
# of 14+ stages compiles slowly and streams the whole ring once per stage
FOURSTEP_MIN_N = 8192
# moduli wider than this run through RNS channels (the int32 arithmetic
# of ops/modmul covers q < 2^29)
SMALL_Q_BITS = 29


def current_platform() -> str:
    """The platform of JAX's default backend: ``"gpu"`` or ``"cpu"``."""
    import jax
    return _checked(jax.default_backend())


def _checked(platform: str) -> str:
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"unsupported platform {platform!r}: tpu-ntt runs on "
            f"{' and '.join(PLATFORMS)}")
    return platform


def select_plan(n: int, q: int, negacyclic: bool = True, mesh=None,
                backend: str = "auto", platform: str | None = None) -> str:
    """The plan kind for Z_q[x]/(x^n ± 1) on ``platform`` (default: the
    current one).

    ``backend``: ``"auto"`` picks; ``"xla"`` keeps the XLA plans;
    ``"pallas"`` demands the fused kernel and raises where it cannot run
    (no GPU, or a ring it does not cover); ``"matmul"`` picks the
    matmul transform for rings with a full NTT."""
    from .ops import fused
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    platform = _checked(platform or current_platform())
    if backend == "pallas" and platform != "gpu":
        raise RuntimeError(
            f"backend='pallas' needs a GPU; this platform is {platform!r}")
    full = (q - 1) % (2 * n if negacyclic else n) == 0
    levels = 0 if full else 1

    if q.bit_length() > SMALL_Q_BITS:
        if not negacyclic:
            raise NotImplementedError(
                "big-q RNS path is negacyclic-only (the channel transforms "
                "and the signed-Garner range analysis assume x^n + 1)")
        kind = "bigq"
    elif not full and not negacyclic:
        raise NotImplementedError(
            f"cyclic ring needs q ≡ 1 (mod n) for a full NTT (got n={n}, "
            f"q={q}); the incomplete-NTT fallback is negacyclic-only")
    elif mesh is not None:
        kind = "sharded"
    elif n > FOURSTEP_MIN_N:
        kind = "fourstep"
    elif backend == "matmul":
        kind = "matmul" if full else "incomplete"
    elif backend != "xla" and platform == "gpu" and fused.supported(
            n, q, negacyclic, levels):
        kind = "fused" if full else "fused-incomplete"
    else:
        kind = "xla" if full else "incomplete"

    if backend == "pallas" and not kind.startswith("fused"):
        raise ValueError(
            f"backend='pallas' requested but the fused kernel does not "
            f"cover n={n}, q={q}, negacyclic={negacyclic}, mesh={mesh}; "
            f"use backend='auto'")
    if backend == "matmul" and kind != "matmul":
        raise ValueError(
            f"backend='matmul' needs a full NTT on one device (n={n}, "
            f"q={q})")
    return kind


def build_plan(n: int, q: int, negacyclic: bool = True, mesh=None,
               backend: str = "auto"):
    """``(kind, plan)``: the plan :func:`select_plan` names for this ring
    on the current platform, built.  A fused kind is the kernel wrapped
    around its XLA plan (``Plan`` or ``IncompletePlan``)."""
    from .params import make_params
    kind = select_plan(n, q, negacyclic, mesh, backend)
    if kind == "bigq":
        from .bigq import BigQPlan
        if (q - 1) % (2 * n) != 0:
            raise ValueError("big q must be NTT-friendly (q ≡ 1 mod 2n)")
        return kind, BigQPlan(make_params(n, q), mesh=mesh)
    if kind in ("incomplete", "fused-incomplete"):
        from .schemes import IncompletePlan
        plan = IncompletePlan(n, q)
        if kind == "fused-incomplete":
            from .ops.fused import FusedPolymul
            plan = FusedPolymul(plan)
        return kind, plan
    p = make_params(n, q, negacyclic=negacyclic)
    if kind == "fourstep":
        from .parallel.sharded import ShardedPlan, make_mesh
        return kind, ShardedPlan(p, make_mesh(1))
    if kind == "sharded":
        from .parallel.sharded import ShardedPlan, mesh_axes
        axis, batch_axis = mesh_axes(mesh)
        return kind, ShardedPlan(p, mesh, axis=axis, batch_axis=batch_axis)
    if kind == "matmul":
        from .ops.matmul_ntt import MatmulNTT
        return kind, MatmulNTT(p)
    from .transform import Plan
    if kind == "fused":
        from .ops.fused import FusedPolymul
        return kind, FusedPolymul(Plan(p))
    return kind, Plan(p)

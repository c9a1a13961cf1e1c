"""tpu-ntt: NTT polynomial multiplication in JAX, with Pallas kernels for GPUs.

A from-scratch rebuild of the capabilities of the FPGA coprocessor in
``regras/NTT-based-polynomial-multiplier-FPGA`` (see SURVEY.md): forward and
inverse number-theoretic transforms (Cooley–Tukey and Gentleman–Sande, all
order variants), twiddle/parameter generation, word-level and Longa–Naehrig
modular reduction, pointwise products, and full cyclic/negacyclic polynomial
multiplication in Z_q[x]/(x^n ± 1) — with the per-device compute expressed
as vectorised XLA graphs and fused Pallas kernels, and large transforms
sharded over a device mesh with collective stage exchanges.
"""

from .params import NTTParams, make_params, find_params, preset, PRESETS
from . import params, ref
from .validation import (DomainError, set_validation, validated,
                         validation_enabled)

__version__ = "0.1.0"

__all__ = [
    "NTTParams", "make_params", "find_params", "preset", "PRESETS",
    "params", "ref", "Plan", "ShardedPlan", "BigQPlan", "Ring",
    "IncompletePlan", "PolyMultEngine", "FusedPolymul", "select_plan",
]


def __getattr__(name):
    # heavier modules (jax import) loaded lazily
    if name == "Plan":
        from .transform import Plan
        return Plan
    if name == "ShardedPlan":
        from .parallel.sharded import ShardedPlan
        return ShardedPlan
    if name == "BigQPlan":
        from .bigq import BigQPlan
        return BigQPlan
    if name == "Ring":
        from .ring import Ring
        return Ring
    if name == "IncompletePlan":
        from .schemes import IncompletePlan
        return IncompletePlan
    if name == "PolyMultEngine":
        from .runtime.engine import PolyMultEngine
        return PolyMultEngine
    if name == "FusedPolymul":
        from .ops.fused import FusedPolymul
        return FusedPolymul
    if name == "select_plan":
        from .dispatch import select_plan
        return select_plan
    raise AttributeError(name)

"""Per-chip compute kernels: modular arithmetic strategies and (fused Pallas, matmul)
transform kernels."""

from .modmul import Arith, MontArith, ShoupArith, select_arith

__all__ = ["Arith", "MontArith", "ShoupArith", "select_arith"]

"""NUFFT layer of the port. The kernel wrappers live in the submodules
:mod:`.spread` and :mod:`.interp` (each with its launch counter)."""

from .direct import direct_type3
from .kernels import ESKernel, es_kernel, es_kernel_ft, es_kernel_grid, next_fast_size
from .transform import Type3Executor, Type3Plan, fit_plan_precorr, plan_type3

__all__ = [
    "ESKernel",
    "Type3Executor",
    "Type3Plan",
    "direct_type3",
    "es_kernel",
    "es_kernel_ft",
    "es_kernel_grid",
    "fit_plan_precorr",
    "next_fast_size",
    "plan_type3",
]

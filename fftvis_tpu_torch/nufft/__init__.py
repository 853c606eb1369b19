"""NUFFT layer of the port. The kernel wrappers live in the submodules
:mod:`.spread` and :mod:`.interp` (each with its launch counter)."""

from .direct import direct_type3
from .kernels import ESKernel, es_kernel, es_kernel_ft, es_kernel_grid, next_fast_size
from .transform import (
    Type3Executor,
    Type3LowrankZExecutor,
    Type3LowrankZPlan,
    Type3Plan,
    fit_plan_precorr,
    make_type3_lowrank_z_fn,
    plan_type3,
    plan_type3_lowrank_z,
)
from .type1 import Type1ExactExecutor, Type1ExactPlan, plan_type1_exact

__all__ = [
    "ESKernel",
    "Type1ExactExecutor",
    "Type1ExactPlan",
    "Type3Executor",
    "Type3LowrankZExecutor",
    "Type3LowrankZPlan",
    "Type3Plan",
    "direct_type3",
    "es_kernel",
    "es_kernel_ft",
    "es_kernel_grid",
    "fit_plan_precorr",
    "make_type3_lowrank_z_fn",
    "next_fast_size",
    "plan_type1_exact",
    "plan_type3",
    "plan_type3_lowrank_z",
]

"""NUFFT layer of the port, with the public surface of
``fftvis_tpu/nufft/__init__.py``. The kernel wrappers live in the
submodules :mod:`.spread` and :mod:`.interp` (each with its launch
counters)."""

from .direct import (
    direct_type1,
    direct_type1_np,
    direct_type2,
    direct_type2_np,
    direct_type3,
    direct_type3_np,
)
from .kernels import ESKernel, es_kernel, es_kernel_ft, es_kernel_grid, next_fast_size
from .transform import (
    Type1Executor,
    Type1Plan,
    Type2Executor,
    Type2Plan,
    Type3Executor,
    Type3LowrankZExecutor,
    Type3LowrankZPlan,
    Type3Plan,
    fit_plan_precorr,
    make_type1_fn,
    make_type2_fn,
    make_type3_fn,
    make_type3_lowrank_z_fn,
    plan_type1,
    plan_type2,
    plan_type3,
    plan_type3_lowrank_z,
)
from .type1 import Type1ExactExecutor, Type1ExactPlan, plan_type1_exact

__all__ = [
    "ESKernel",
    "Type1ExactExecutor",
    "Type1ExactPlan",
    "Type1Executor",
    "Type1Plan",
    "Type2Executor",
    "Type2Plan",
    "Type3Executor",
    "Type3LowrankZExecutor",
    "Type3LowrankZPlan",
    "Type3Plan",
    "direct_type1",
    "direct_type1_np",
    "direct_type2",
    "direct_type2_np",
    "direct_type3",
    "direct_type3_np",
    "es_kernel",
    "es_kernel_ft",
    "es_kernel_grid",
    "fit_plan_precorr",
    "make_type1_fn",
    "make_type2_fn",
    "make_type3_fn",
    "make_type3_lowrank_z_fn",
    "next_fast_size",
    "plan_type1",
    "plan_type1_exact",
    "plan_type2",
    "plan_type3",
    "plan_type3_lowrank_z",
]

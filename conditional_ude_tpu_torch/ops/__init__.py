"""Numerical ops of the PyTorch port: interpolation, the batched RK4 and
Tsit5, the batched L-BFGS and the kernels' wrappers (counterpart of
``conditional_ude_tpu/ops``; the JAX package's ``*_pallas`` functions are
``cohort_sse`` (K4), ``population_sse`` (K1) and ``cohort_sse_tsit5``
(K3) here).  The kernels are built at their first launch, never on
import."""

from conditional_ude_tpu_torch import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "interp": ["LinearInterp"],
    "lbfgs": ["LBFGSResult", "lbfgs_minimize"],
    "rk4": ["solve_rk4"],
    "rk4_cohort": ["cohort_sse"],
    "rk4_population": ["population_sse"],
    "tsit5": ["SolveResult", "solve_tsit5"],
    "tsit5_cohort": ["cohort_sse_tsit5"],
})

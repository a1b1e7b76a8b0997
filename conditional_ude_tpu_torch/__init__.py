"""conditional_ude_tpu_torch — the PyTorch/CUDA port of ``conditional_ude_tpu``.

A second package beside the JAX one, which stays the reference.  It runs
exp02 (frozen candidates or ``--retrain``), its covariate variant exp07 and
its enlarged multi-start exp02_xl, the non-conditional UDE of exp01, and
the symbolic refits of exp03, exp04 and exp_symreg_production
(``python -m conditional_ude_tpu_torch [--experiment NAME]``, on the card
by default).

Conventions:
  * tensors are ``torch.float32`` throughout, as in the JAX package;
  * every function that makes tensors takes an explicit ``device``; nothing
    picks a device by itself;
  * batch axes lead and the individual axis is last (``betas[..., N]``), so
    candidate networks, profile grid points and individuals are one batch;
  * the kernels (``ops/rk4_cohort.py``, ``rk4_population.py``,
    ``lane_grad.py``, ``population_grad.py``, ``tsit5_cohort.py``) are CUDA
    C++ for Hopper, built by ``nvcc`` at first use; a CPU tensor takes
    their plain PyTorch versions.

The package never imports ``jax`` or ``conditional_ude_tpu``.
"""

__version__ = "0.1.0"

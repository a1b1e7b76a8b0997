"""conditional_ude_tpu_torch — the PyTorch/CUDA port of ``conditional_ude_tpu``.

A second package beside the JAX one, which stays the reference.  This slice
ports the frozen-network path: with a trained network held fixed, each
person's conditional parameter β (and noise σ) is re-estimated, the
validation split selects among the trained candidates, and the likelihood
profiles give the identifiability census
(``python -m conditional_ude_tpu_torch --device cuda``).

Conventions:
  * tensors are ``torch.float32`` throughout, as in the JAX package;
  * every function that makes tensors takes an explicit ``device``; nothing
    picks a device by itself;
  * batch axes lead and the individual axis is last (``betas[..., N]``), so
    candidate networks, profile grid points and individuals are one batch;
  * the fused cohort RK4 kernel (``ops/rk4_cohort.py``) is CUDA C++ for
    Hopper, built by ``nvcc`` at first use; a CPU tensor takes its plain
    PyTorch version.

The package never imports ``jax`` or ``conditional_ude_tpu``.
"""

__version__ = "0.1.0"

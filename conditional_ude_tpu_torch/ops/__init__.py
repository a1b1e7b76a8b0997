"""Numerical ops of the PyTorch port: interpolation, the batched RK4, the
batched L-BFGS and the fused cohort RK4 kernel (``rk4_cohort``)."""

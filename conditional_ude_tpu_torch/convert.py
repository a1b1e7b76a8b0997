"""Weights carried across from the JAX package.

Both packages lay a network's parameters out as the same flat vector, so a
JAX parameter array converts by value alone, and the trained candidates in
``cude_neural_parameters.npz`` load unchanged.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.nn import MLP
from conditional_ude_tpu_torch.utils.checkpoint import load_checkpoint


def params_from_jax(flat: np.ndarray, net: MLP,
                    device: torch.device | str) -> torch.Tensor:
    """A flat JAX parameter array ``[..., P]`` as a float32 tensor on
    ``device``, rows contiguous whatever the file's memory order (the xl
    candidates are stored column-major), as the kernels read them."""
    flat = np.ascontiguousarray(flat)
    if flat.shape[-1] != net.num_params:
        raise ValueError(f"expected {net.num_params} parameters per network, "
                         f"got shape {flat.shape}")
    return torch.as_tensor(flat, dtype=torch.float32, device=device)


def load_candidates(npz: str | Path):
    """Trained candidates of a joint multi-start fit.

    Returns ``(nn[R, P], betas[R, N_fit, 1], idx_fit[N_fit], orientations[R])``
    as numpy arrays: the candidate networks, their training β's, the fit
    subjects' indices in the training split, and each candidate's ±1 β gauge.
    """
    arrays, _ = load_checkpoint(npz)
    return (arrays["nn_params"], arrays["betas"], arrays["idx_fit"],
            arrays["orientations"])


def candidate_objectives(npz: str | Path) -> np.ndarray:
    """The candidates' training objectives ``[R]``, in the file's order: a
    joint multi-start stores its candidates best first."""
    arrays, _ = load_checkpoint(npz)
    return np.asarray(arrays["objectives"])

"""The cross-check against the reference's trained weights (counterpart of
``experiments/exp_parity.py``).

At the reference's selected network and its training β's
(``data/jld2.py::load_reference_cude`` reads them from the reference's
``cude_neural_parameters.jld2``), :func:`run_parity` re-estimates (β, σ)
on the training and the test cohorts apart, within the reference's
training-β range widened by 10 % (``02-conditional.jl:91-106``), back-
converts each subject's SSE from the σ-NLL, and checks the solvers against
each other at the fitted test β's: RK4 at 8 substeps against adaptive
Tsit5 at rtol 1e-6, atol 1e-9 (at most 4,096 steps).  The fits are the
eager ones of ``fit/train.py``, and nothing here launches a kernel.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from conditional_ude_tpu_torch.convert import params_from_jax
from conditional_ude_tpu_torch.data.jld2 import load_reference_cude
from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_ohashi
from conditional_ude_tpu_torch.models.cpeptide import (
    CPeptideModel,
    simulate_cohort,
)
from conditional_ude_tpu_torch.nn import chain
from conditional_ude_tpu_torch.pipeline import (
    _cohort,
    refit_split,
    sse_per_type,
    widened_bounds,
)

SMOKE_SUBJECTS = 8          # the JAX script's --smoke cohorts
AGREEMENT = 2e-4            # the largest RK4-Tsit5 gap that counts as agreement


@dataclasses.dataclass
class ParityRun:
    metrics: dict           # the JAX script's keys
    bounds: tuple[float, float]
    fits: dict              # (β, σ, objective, SSE) of each split
    seconds: dict


def run_parity(device: torch.device | str, nn: np.ndarray, betas_fit,
               train: OhashiSplit, test: OhashiSplit,
               best_model_index: int, lbfgs_iters: int = 1000,
               width: int = 4, depth: int = 2) -> ParityRun:
    """exp_parity on ``device`` at the network ``nn[P]`` (this package's
    layout) and its training β's ``betas_fit``."""
    dev = torch.device(device)
    model = CPeptideModel(chain(width, depth, "tanh", input_dims=2))
    net = params_from_jax(nn, model.net, dev)
    bounds = widened_bounds(betas_fit)
    cohort_train, cohort_test = _cohort(train, dev), _cohort(test, dev)
    seconds = {}
    t0 = time.perf_counter()
    fits = {}
    for tag, cohort in (("train", cohort_train), ("test", cohort_test)):
        b, s, o = refit_split(model, net, (cohort,), bounds, lbfgs_iters)
        n_t = cohort.timepoints.shape[0]
        sse = (o - (n_t / 2) * np.log(s**2)) * (2 * s**2)
        fits[tag] = {"beta": b, "sigma": s, "objective": o, "sse": sse}
    seconds["refit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    b_te = torch.as_tensor(fits["test"]["beta"], device=dev)
    with torch.no_grad():
        rk = simulate_cohort(model, net, b_te, cohort_test, solver="rk4",
                             substeps=8)
        t5 = simulate_cohort(model, net, b_te, cohort_test, solver="tsit5",
                             rtol=1e-6, atol=1e-9, max_steps=4096)
    ok = t5.success.cpu().numpy()
    delta = np.abs(rk.ys[..., 0].cpu().numpy()[ok]
                   - t5.ys[..., 0].cpu().numpy()[ok])
    seconds["solvers"] = time.perf_counter() - t0

    sse_tr, sse_te = fits["train"]["sse"], fits["test"]["sse"]
    n_t = test.timepoints.shape[0]
    metrics = {
        "best_model_index": int(best_model_index),
        # the reference prints per-type means over both cohorts together
        "sse_per_type_combined": sse_per_type(
            np.concatenate([train.types, test.types]),
            np.concatenate([sse_tr, sse_te])),
        "sse_per_type_train": sse_per_type(train.types, sse_tr),
        "sse_per_type_test": sse_per_type(test.types, sse_te),
        "mse_mean_test": float((sse_te / n_t).mean()),
        "beta_mean_train_refit": float(fits["train"]["beta"].mean()),
        "beta_mean_reference_fit": float(np.mean(betas_fit)),
        "solver_max_abs_delta": float(delta.max()),
        "solver_agreement_ok": bool(delta.max() < AGREEMENT),
    }
    return ParityRun(metrics, bounds, fits, seconds)


def run_exp_parity(device: torch.device | str, weights: str | Path,
                   data_dir: str | Path, smoke: bool = False) -> ParityRun:
    """exp_parity from the reference's files: the weights cache
    ``weights`` (JLD2; needs h5py) and the raw CSV files under
    ``data_dir/ohashi_csv``; ``smoke`` keeps the first 8 subjects of each
    split and 100 L-BFGS steps."""
    ref = load_reference_cude(weights)
    best = ref["best_model_index"]
    train, test = load_ohashi(Path(data_dir) / "ohashi_csv")
    if smoke:
        train, test = (s.subset(np.arange(min(SMOKE_SUBJECTS, len(s.ages))))
                       for s in (train, test))
    return run_parity(device, ref["parameters"][best], ref["betas"][best],
                      train, test, best, lbfgs_iters=100 if smoke else 1000,
                      width=ref["width"], depth=ref["depth"])

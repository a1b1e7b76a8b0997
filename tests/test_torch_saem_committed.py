"""PyTorch port: SAEM's per-individual MAP and MLE fits of all 117 Ohashi
subjects from the fixed effects of the committed fit
(``artifacts/saem_fit.npz``, made on a TPU), held to that file's
``beta_map`` and ``beta_mle`` at twice the JAX package's own miss on the
CPU, from ``python scripts/saem_reference.py`` (its ``miss``): at the median
over the 117 subjects 1.669e-6 and 3.038e-4, at most 4.316e-5 and, over all
but subject 84, 1.003e-3; subject 84's MLE, where the likelihood is flat,
0.6952.  ``chip_smoke.py`` holds the card to the same limits
(``SAEM_MISS``).
"""

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu_torch.data.ohashi import OhashiSplit, load_npz
from conditional_ude_tpu_torch.fit import saem
from conditional_ude_tpu_torch.models.cpeptide import (
    CPeptideModel,
    build_cohort,
)
from conditional_ude_tpu_torch.nn import chain

MISS = {"map": {"median": 1.669e-6, "max": 4.316e-5},
        "mle": {"median": 3.038e-4, "max": 1.003e-3}}
FLAT_SUBJECT, FLAT_MISS = 84, 0.6952


@pytest.fixture(scope="module")
def committed():
    both = OhashiSplit.concatenate(*load_npz("artifacts/ohashi.npz"))
    cohort = build_cohort(both.glucose, both.timepoints, both.cpeptide,
                          both.ages, both.t2dm, "cpu")
    fit = np.load("artifacts/saem_fit.npz")
    ll = saem.cude_loglik(CPeptideModel(chain(4, 2)), cohort)
    theta, sigma, eta, omega = (torch.as_tensor(fit[k]) for k in
                                ("nn_params", "sigma", "eta", "omega"))
    init = torch.full((cohort.n,), float(eta))
    return fit, ll, theta, sigma, eta, omega, init


@pytest.mark.parametrize("estimator", ["map", "mle"])
def test_fits_from_the_committed_fixed_effects(committed, estimator):
    fit, ll, theta, sigma, eta, omega, init = committed
    if estimator == "map":
        got = saem.individual_maps(ll, theta, sigma, init, eta, omega)
        diff = np.abs(got.numpy() - fit["beta_map"])
        others = diff
    else:
        got = saem.individual_mles(ll, theta, sigma, init)
        diff = np.abs(got.numpy() - fit["beta_mle"])
        assert diff[FLAT_SUBJECT] <= 2 * FLAT_MISS, diff[FLAT_SUBJECT]
        others = np.delete(diff, FLAT_SUBJECT)
    assert diff.shape == (117,)
    assert np.median(diff) <= 2 * MISS[estimator]["median"], np.median(diff)
    assert others.max() <= 2 * MISS[estimator]["max"], (
        int(others.argmax()), float(others.max()))

"""Likelihood profiles, identifiability and the symbolic-regression search
of the PyTorch port (counterpart of ``conditional_ude_tpu/analysis``)."""

from conditional_ude_tpu_torch import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "profiles": [
        "THRESHOLDS", "ConfidenceInterval", "Profile",
        "classify_identifiability", "cohort_beta_profiles",
        "find_confidence_intervals", "likelihood_profile",
    ],
    "symreg": ["SymRegConfig", "SymRegResult", "fit_symbolic", "pareto_front"],
})

"""The c-peptide model and its symbolic heads in the PyTorch port
(counterpart of ``conditional_ude_tpu/models``).  The JAX package's
``Individual`` is a ``Cohort`` of one here (``build_individual``)."""

from conditional_ude_tpu_torch import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "cpeptide": [
        "CPeptideModel", "Cohort", "build_cohort", "build_individual",
        "simulate", "simulate_cohort", "van_cauter_parameters",
    ],
    "symbolic": [
        "beta_to_k", "fit_k_sigma", "symbolic_model", "symbolic_production",
    ],
})

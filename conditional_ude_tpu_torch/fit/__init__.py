"""Losses, training, the frozen-network fits, SAEM and ADVI of the
PyTorch port (counterpart of ``conditional_ude_tpu/fit``)."""

from conditional_ude_tpu_torch import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "losses": ["conditional_sse", "population_sse", "sse", "sse_sigma"],
    "optim": ["AdamResult", "adam_minimize"],
    "saem": [
        "SAEMConfig", "SAEMResult", "individual_maps", "individual_mles",
        "posterior_chains", "run_saem", "saem_cude", "saem_symbolic",
    ],
    "train": [
        "TrainConfig", "TrainResult", "evaluate_model", "fit_betas",
        "fit_betas_sigma", "select_best", "train_conditional", "train_ude",
    ],
})

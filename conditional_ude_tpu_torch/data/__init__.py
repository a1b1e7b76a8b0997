"""Cohort data of the PyTorch port (counterpart of
``conditional_ude_tpu/data``): the npz files and the raw CSV readers."""

from conditional_ude_tpu_torch import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "fujita": ["FujitaCohort", "load_fujita"],
    "ohashi": ["OhashiSplit", "load_npz", "load_ohashi", "save_npz"],
})

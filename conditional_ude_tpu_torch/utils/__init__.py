"""Statistics and checkpoint helpers of the PyTorch port (counterpart of
``conditional_ude_tpu/utils``)."""

from conditional_ude_tpu_torch import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "checkpoint": ["cached", "load_checkpoint", "save_checkpoint"],
    "stats": [
        "argmedian", "latin_hypercube", "mann_whitney_u", "spearman",
        "stratified_split",
    ],
})

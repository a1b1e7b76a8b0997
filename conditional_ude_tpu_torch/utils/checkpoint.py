"""Read checkpoints written by the JAX package (counterpart of
``conditional_ude_tpu/utils/checkpoint.py:38``): an ``.npz`` of named arrays
and its ``.json`` metadata sidecar."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def load_checkpoint(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """Arrays and metadata (``{}`` when there is no sidecar) of ``path``."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_suffix(path.suffix + ".npz")
    with np.load(path, allow_pickle=False) as data:
        arrays = dict(data)
    meta_path = path.with_suffix(".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return arrays, meta

"""Checkpoints in the JAX package's format (counterpart of
``conditional_ude_tpu/utils/checkpoint.py``): an ``.npz`` of named arrays
and its ``.json`` metadata sidecar, so each package reads the other's
files."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable

import numpy as np


def _npz_path(path: str | Path) -> Path:
    """``path`` with the ``.npz`` suffix that ``np.savez`` appends."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def save_checkpoint(path: str | Path, arrays: dict[str, Any],
                    metadata: dict | None = None) -> None:
    """Named arrays (tensors are copied to the host) to ``path`` (.npz),
    and ``metadata`` to its JSON sidecar."""
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: _host(v) for k, v in arrays.items()})
    if metadata is not None:
        path.with_suffix(".json").write_text(json.dumps(metadata, indent=2))


def load_checkpoint(path: str | Path) -> tuple[dict[str, np.ndarray], dict]:
    """Arrays and metadata (``{}`` when there is no sidecar) of ``path``."""
    path = _npz_path(path)
    with np.load(path, allow_pickle=False) as data:
        arrays = dict(data)
    meta_path = path.with_suffix(".json")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return arrays, meta


def cached(path: str | Path, compute: Callable[[], dict[str, Any]],
           retrain: bool = False,
           metadata: dict | None = None) -> dict[str, np.ndarray]:
    """The arrays of ``path`` if it exists and ``retrain`` is false, else
    ``compute()``'s, saved to ``path`` first."""
    path = _npz_path(path)
    if path.exists() and not retrain:
        return load_checkpoint(path)[0]
    arrays = {k: _host(v) for k, v in compute().items()}
    save_checkpoint(path, arrays, metadata)
    return arrays


def _host(value) -> np.ndarray:
    if hasattr(value, "detach"):            # a torch tensor
        value = value.detach().cpu().numpy()
    return np.asarray(value)

"""Readers of the reference repository's JLD2 (HDF5) weight files
(counterpart of ``conditional_ude_tpu/data/jld2.py``).

The reference caches its trained cUDE in
``source_data/cude_neural_parameters.jld2`` (25 candidate networks, each
candidate's training β's and a 1-based ``best_model_index``) and its 25
ADVI runs in ``source_data/advi/cude_result_<n>.jld2`` (posterior-mean
network and β's).  SimpleChains flattens each dense layer as ``[vec(W);
b]`` with Julia's column-major ``vec``, so a (fan_in × fan_out) reshape and
a transpose give this package's row-major ``W[fan_out, fan_in]``
(:func:`simplechains_to_flat`).

Reading HDF5 needs ``h5py``, which each reader imports when it runs: the
package itself does not need it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _h5py(path: Path):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading {path} needs h5py, which is not "
                          "installed") from e
    return h5py


def layer_dims(width: int, depth: int,
               input_dims: int = 2) -> list[tuple[int, int]]:
    """(fan_in, fan_out) of each layer of the cUDE's network: [ΔG, β] →
    ``width`` ^ ``depth`` → 1."""
    fans = [input_dims] + [width] * depth + [1]
    return list(zip(fans[:-1], fans[1:]))


def simplechains_to_flat(w: np.ndarray, dims) -> np.ndarray:
    """A SimpleChains parameter vector in this package's layout (float32)."""
    out, i = [], 0
    for fi, fo in dims:
        out.append(w[i:i + fi * fo].reshape(fi, fo).T.reshape(-1))
        i += fi * fo
        out.append(w[i:i + fo])
        i += fo
    return np.concatenate(out).astype(np.float32)


def load_reference_cude(path: str | Path) -> dict:
    """The reference's cUDE weight cache: ``parameters`` [R, P] in this
    package's layout, ``betas`` (a list of each candidate's training β's),
    ``best_model_index`` (0-based), ``width`` and ``depth``."""
    path = Path(path)
    with _h5py(path).File(path, "r") as f:
        width, depth = int(f["width"][()]), int(f["depth"][()])
        best = int(f["best_model_index"][()]) - 1     # Julia is 1-based
        dims = layer_dims(width, depth)
        params = [simplechains_to_flat(np.array(f[r]), dims)
                  for r in f["parameters"][()]]
        betas = [np.array(f[r]) for r in f["betas"][()]]
    return {"parameters": np.stack(params), "betas": betas,
            "best_model_index": best, "width": width, "depth": depth}


def load_reference_advi(advi_dir: str | Path) -> dict:
    """The reference's per-restart ADVI results, ``cude_result_<n>.jld2``
    in the order of ``n`` (``_10`` after ``_2``): ``parameters`` [R, P] in
    this package's layout, ``betas`` [R, N_fit] (the posterior means of
    each run's 57 training subjects, a Julia-drawn subset), ``width`` and
    ``depth``."""
    advi_dir = Path(advi_dir)
    paths = sorted(advi_dir.glob("cude_result_*.jld2"),
                   key=lambda p: int(p.stem.rsplit("_", 1)[1]))
    if not paths:
        raise FileNotFoundError(f"no cude_result_*.jld2 under {advi_dir}")
    params, betas = [], []
    for p in paths:
        with _h5py(p).File(p, "r") as f:
            width, depth = int(f["width"][()]), int(f["depth"][()])
            params.append(simplechains_to_flat(np.array(f["parameters"]),
                                               layer_dims(width, depth)))
            betas.append(np.array(f["betas"]))
    return {"parameters": np.stack(params), "betas": np.stack(betas),
            "width": width, "depth": depth}

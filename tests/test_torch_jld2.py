"""PyTorch port: the JLD2 readers (``data/jld2.py``), exp_parity
(``parity_pipeline.py``) and exp_advi's cross-check statistics
(``advi_pipeline.py``, section 3) against the JAX package.

The reference's JLD2 files are not in the repository, so the tests write
HDF5 files in their layout with h5py: scalar ``width``, ``depth`` and a
1-based ``best_model_index``; ``parameters`` and ``betas`` as datasets of
object references; the weights those of ``artifacts/cude_neural_parameters
.npz`` in SimpleChains' layout (each layer's W column-major, then b); and
the ADVI runs as ``cude_result_{1,2,10}.jld2``."""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch
from etl_fixtures import write_ohashi_csvs
from torch_threads import one_thread  # noqa: F401

from conditional_ude_tpu.data import jld2 as jjld2
from conditional_ude_tpu_torch import __main__ as entry
from conditional_ude_tpu_torch import advi_pipeline, parity_pipeline
from conditional_ude_tpu_torch.data import jld2
from conditional_ude_tpu_torch.data.ohashi import load_npz
from conditional_ude_tpu_torch.fit.advi import advi_betas
from conditional_ude_tpu_torch.models.cpeptide import (
    CPeptideModel,
    build_cohort,
)
from conditional_ude_tpu_torch.nn import chain

REPO = Path(__file__).resolve().parent.parent
ART = REPO / "artifacts"
GOLDEN = REPO / "tests" / "golden" / "reference_parity_golden.npz"
BEST = 13               # results/exp_parity_metrics.json, 0-based
ADVI_RUNS = (1, 2, 10)  # file numbers; numeric order puts 10 last


def to_simplechains(flat: np.ndarray, dims) -> np.ndarray:
    """This package's layout to SimpleChains': each W[fo, fi] column-major,
    then b (the inverse of ``simplechains_to_flat``)."""
    out, i = [], 0
    for fi, fo in dims:
        out.append(flat[i:i + fi * fo].reshape(fo, fi).ravel(order="F"))
        i += fi * fo
        out.append(flat[i:i + fo])
        i += fo
    return np.concatenate(out).astype(np.float64)


def _refs(f, group: str, arrays) -> np.ndarray:
    g = f.create_group(group)
    for i, a in enumerate(arrays):
        g[str(i)] = a
    return np.array([g[str(i)].ref for i in range(len(arrays))],
                    dtype=h5py.ref_dtype)


@pytest.fixture(scope="module")
def candidates():
    """The committed candidates and their training β's, with the reference's
    own selected network and its β's (``tests/golden``) as candidate
    ``BEST``."""
    with np.load(ART / "cude_neural_parameters.npz") as z:
        nn, betas = z["nn_params"].copy(), list(z["betas"][..., 0]
                                                .astype(np.float64))
    with np.load(GOLDEN) as g:
        nn[BEST], betas[BEST] = g["nn"], g["betas_train"].astype(np.float64)
    return nn, betas


@pytest.fixture(scope="module")
def source_data(tmp_path_factory, candidates):
    """``<tmp>/data/ohashi_csv`` and ``<tmp>/source_data`` in the reference
    repository's layout."""
    root = tmp_path_factory.mktemp("reference")
    write_ohashi_csvs(root / "data")
    src = root / "source_data"
    (src / "advi").mkdir(parents=True)
    nn, betas = candidates
    dims = jld2.layer_dims(4, 2)
    with h5py.File(src / "cude_neural_parameters.jld2", "w") as f:
        f["width"], f["depth"], f["best_model_index"] = 4, 2, BEST + 1
        f["parameters"] = _refs(f, "_p", [to_simplechains(w, dims)
                                          for w in nn])
        f["betas"] = _refs(f, "_b", list(betas))
    for k, n in enumerate(ADVI_RUNS):
        with h5py.File(src / "advi" / f"cude_result_{n}.jld2", "w") as f:
            f["width"], f["depth"] = 4, 2
            f["parameters"] = to_simplechains(nn[k], dims)
            f["betas"] = betas[k]
    return root


def test_cude_reader_equals_jax_and_round_trips(source_data, candidates):
    path = source_data / "source_data" / "cude_neural_parameters.jld2"
    got, want = jld2.load_reference_cude(path), jjld2.load_reference_cude(path)
    assert got.keys() == want.keys()
    for k in ("best_model_index", "width", "depth"):
        assert got[k] == want[k]
    assert got["best_model_index"] == BEST
    assert got["parameters"].dtype == want["parameters"].dtype == np.float32
    np.testing.assert_array_equal(got["parameters"], want["parameters"])
    np.testing.assert_array_equal(got["parameters"], candidates[0])
    assert len(got["betas"]) == len(want["betas"]) == 25
    for g, w, c in zip(got["betas"], want["betas"], candidates[1]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, c)


def test_advi_reader_equals_jax_in_numeric_order(source_data, candidates):
    d = source_data / "source_data" / "advi"
    got, want = jld2.load_reference_advi(d), jjld2.load_reference_advi(d)
    assert (got["width"], got["depth"]) == (want["width"], want["depth"])
    for k in ("parameters", "betas"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    # cude_result_10 is the third run, not the second
    np.testing.assert_array_equal(got["parameters"],
                                  candidates[0][:len(ADVI_RUNS)])
    np.testing.assert_array_equal(got["betas"],
                                  np.stack(candidates[1][:len(ADVI_RUNS)]))


def test_advi_reader_refuses_an_empty_folder(tmp_path):
    with pytest.raises(FileNotFoundError, match="cude_result"):
        jld2.load_reference_advi(tmp_path)


def test_readers_without_h5py_name_it_and_the_file(source_data,
                                                   monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = source_data / "source_data" / "cude_neural_parameters.jld2"
    with pytest.raises(ImportError, match="h5py") as err:
        jld2.load_reference_cude(path)
    assert str(path) in str(err.value)
    with pytest.raises(ImportError, match="cude_result_1.jld2"):
        jld2.load_reference_advi(source_data / "source_data" / "advi")


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exp_parity_smoke_matches_jax(source_data, tmp_path, monkeypatch,
                                      capsys):
    """The entry point at the JAX script's --smoke size (8 subjects a
    split, 100 L-BFGS steps) against the JAX script itself; the fits at
    ``tests/test_torch_frozen.py``'s tolerances."""
    data, weights = (source_data / "data",
                     source_data / "source_data" / "cude_neural_parameters.jld2")
    entry.main(["--experiment", "exp_parity", "--data-dir", str(data),
                "--smoke", "--device", "cpu", "--out", str(tmp_path / "p")])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads((tmp_path / "p" / "exp_parity_metrics.json")
                      .read_text()) == got

    jax_parity = _jax_script("exp_parity")
    monkeypatch.setattr(jax_parity, "configure_backend", lambda args: None)
    monkeypatch.setattr(sys, "argv", [
        "exp_parity.py", "--smoke", "--data-dir", str(data), "--weights",
        str(weights), "--results", str(tmp_path / "j")])
    jax_parity.main()
    want = json.loads((tmp_path / "j" / "exp_parity_metrics.json")
                      .read_text())
    assert got.keys() == want.keys()
    for k in ("best_model_index", "beta_mean_reference_fit",
              "solver_agreement_ok"):
        assert got[k] == want[k], k
    assert got["solver_agreement_ok"]
    np.testing.assert_allclose(got["beta_mean_train_refit"],
                               want["beta_mean_train_refit"], atol=2e-3)
    # an SSE is (objective − n/2·log σ²)·2σ²: σ's 5e-3 makes it 1e-2
    for k in ("sse_per_type_combined", "sse_per_type_train",
              "sse_per_type_test"):
        assert got[k].keys() == want[k].keys()
        for t in want[k]:
            np.testing.assert_allclose(got[k][t], want[k][t], rtol=1e-2,
                                       err_msg=f"{k} {t}")
    np.testing.assert_allclose(got["mse_mean_test"], want["mse_mean_test"],
                               rtol=1e-2)
    np.testing.assert_allclose(got["solver_max_abs_delta"],
                               want["solver_max_abs_delta"], rtol=0.5)


def test_parity_fits_match_jax_fits(candidates):
    """``run_parity``'s refits against the JAX package's
    ``fit_betas_sigma`` on the same subjects and bounds, at
    ``tests/test_torch_frozen.py``'s tolerances."""
    import jax.numpy as jnp

    from conditional_ude_tpu.fit.train import fit_betas_sigma
    from conditional_ude_tpu.models import cpeptide as jcp
    from conditional_ude_tpu.nn import chain as jax_chain

    train, test = (s.subset(np.arange(6)) for s in load_npz(ART
                                                            / "ohashi.npz"))
    nn, betas = candidates[0][BEST], candidates[1][BEST]
    run = parity_pipeline.run_parity("cpu", nn, betas, train, test, BEST,
                                     lbfgs_iters=100)
    lb, ub = run.bounds
    assert (lb, ub) == (float(betas.min() - 0.1 * abs(betas.min())),
                        float(betas.max() + 0.1 * abs(betas.max())))
    jmodel = jcp.CPeptideModel(kind="conditional",
                               net=jax_chain(4, 2, "tanh", input_dims=2))
    for tag, split in (("train", train), ("test", test)):
        jc = jcp.build_cohort(split.glucose, split.timepoints,
                              split.cpeptide, split.ages, split.t2dm)
        jb, js, jo = (np.asarray(a) for a in fit_betas_sigma(
            jmodel, jnp.asarray(nn), jc, -1.0, (lb, ub), 100))
        fit = run.fits[tag]
        np.testing.assert_allclose(fit["objective"], jo, rtol=1e-4)
        np.testing.assert_allclose(fit["beta"], jb, atol=2e-3)
        np.testing.assert_allclose(fit["sigma"], js, rtol=5e-3)


def _jax_crosscheck_formulas(ours, theirs):
    """``experiments/exp_advi.py:207-218``, as written there."""
    qs = (np.arange(theirs.shape[1]) + 0.5) / theirs.shape[1]
    qcorr, qoff, qrmse_c = [], [], []
    for r in range(theirs.shape[0]):
        our_q = np.quantile(ours[r], qs)
        ref_q = np.sort(theirs[r])
        qcorr.append(float(np.corrcoef(our_q, ref_q)[0, 1]))
        off = float(np.mean(our_q - ref_q))
        qoff.append(off)
        qrmse_c.append(float(np.sqrt(np.mean(
            (our_q - ref_q - off) ** 2))))
    return {
        "quantile_corr_per_restart_median": float(np.median(qcorr)),
        "quantile_corr_per_restart_min": float(np.min(qcorr)),
        "quantile_offset_median": float(np.median(qoff)),
        "quantile_rmse_centered_median": float(np.median(qrmse_c)),
        "beta_mean_range_ref": [float(theirs.mean(1).min()),
                                float(theirs.mean(1).max())],
        "beta_mean_range_ours": [float(ours.mean(1).min()),
                                 float(ours.mean(1).max())],
    }


def test_crosscheck_statistics_are_the_jax_formulas():
    rng = np.random.default_rng(5)
    ours = rng.normal(-2.0, 1.0, (25, 82)).astype(np.float32)
    theirs = rng.normal(-0.7, 0.8, (25, 57))
    got = advi_pipeline.crosscheck_statistics(ours, theirs, 1.5)
    want = _jax_crosscheck_formulas(ours, theirs)
    assert list(got) == ["n_files", "seconds", *want, "note"]
    assert got["n_files"] == 25 and got["seconds"] == 1.5
    for k, v in want.items():
        assert got[k] == v, k


def test_crosscheck_runs_advi_at_each_reference_network(source_data):
    """Section 3 on the CPU at 5 steps: each run's β posterior means of all
    82 training subjects, from a generator seeded 100 + r, then the
    statistics."""
    ref = jld2.load_reference_advi(source_data / "source_data" / "advi")
    train, _ = load_npz(ART / "ohashi.npz")
    stats = advi_pipeline.reference_crosscheck("cpu", ref, train, steps=5)
    model = CPeptideModel(chain(4, 2))
    cohort = build_cohort(train.glucose, train.timepoints, train.cpeptide,
                          train.ages, train.t2dm, "cpu")
    ours = np.stack([advi_betas(
        model, torch.as_tensor(ref["parameters"][r]), cohort,
        initial_beta=-1.0, steps=5,
        generator=torch.Generator().manual_seed(100 + r),
        substeps=4).beta_mean.numpy() for r in range(len(ADVI_RUNS))])
    assert ours.shape == (3, 82)
    assert stats == advi_pipeline.crosscheck_statistics(
        ours, ref["betas"], stats["seconds"])
    with pytest.raises(ValueError, match="drifted"):
        advi_pipeline.reference_crosscheck("cpu", dict(ref, width=5), train,
                                           steps=1)


def test_exp_advi_entry_says_where_it_skipped_section_3(tmp_path, capsys):
    args = SimpleNamespace(data_dir=tmp_path / "data", artifacts=ART,
                           device="cpu")
    run = SimpleNamespace(metrics={})
    entry._advi_crosscheck(args, run)
    assert run.metrics == {}
    assert capsys.readouterr().err.strip() == (
        "[exp_advi] reference ADVI cross-check skipped (not found at "
        f"{tmp_path / 'source_data' / 'advi'})")

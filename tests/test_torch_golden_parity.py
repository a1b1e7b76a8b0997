"""PyTorch port: the frozen solutions of the reference against ground truth.

``tests/golden/reference_parity_golden.npz`` holds the reference's trained
weights (37), the β of each of the 82 training and 35 test subjects of the
Ohashi cohort, and their trajectories solved by DOP853 at rtol 1e-10
(``traj_*``, ``[82, 5]`` and ``[35, 5]``) with the per-subject SSE
(``sse_*``).  The port's ``simulate_cohort`` on the committed cohort
(``artifacts/ohashi.npz``, the same subjects in the same order) must
reproduce them within the bounds ``tests/test_reference_parity.py`` sets for
the JAX package: RK4 at 8 substeps within 5e-3, Tsit5 at the reference's
defaults (rtol 1e-3, atol 1e-6) within 2.5e-2, Tsit5 at rtol 1e-6 / atol
1e-9 within 5e-4 (the float32 accumulation floor), and the mean and
per-type SSE of default-tolerance solves within 1 %.

The same solvers in float64 (weights, β and cohort in float64; the time
grid stays the float32 one), and RK4 at 64 substeps, split each float32
delta into the solver's own error and float32 rounding: a delta that
float64 does not shrink is the solver's; the tight RK4 shows the float32
floor.  Run as a script, the file prints the
deltas as one JSON line:

    python tests/test_torch_golden_parity.py
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":      # pytest's conftest does this for the tests
    sys.path.insert(0, str(ROOT))

from conditional_ude_tpu_torch.data.ohashi import load_npz  # noqa: E402
from conditional_ude_tpu_torch.models.cpeptide import (  # noqa: E402
    CPeptideModel,
    build_cohort,
    simulate_cohort,
)
from conditional_ude_tpu_torch.nn import chain  # noqa: E402

GOLDEN = ROOT / "tests" / "golden" / "reference_parity_golden.npz"
# solver options and their bound on |trajectory − DOP853| (nmol/L)
SOLVES = {"rk4, 8 substeps": (dict(solver="rk4", substeps=8), 5e-3),
          "tsit5, defaults": (dict(solver="tsit5"), 2.5e-2),
          "tsit5, rtol 1e-6": (dict(solver="tsit5", rtol=1e-6, atol=1e-9,
                                    max_steps=4096), 5e-4)}
# a tighter solve, for the split of the deltas only
TIGHT = {"rk4, 64 substeps": dict(solver="rk4", substeps=64)}
CASTS = ("glucose", "cpeptide", "age", "k0", "k1", "k2", "c0")


def _golden():
    golden = np.load(GOLDEN)
    splits = dict(zip(("train", "test"), load_npz(ROOT / "artifacts"
                                                  / "ohashi.npz")))
    model = CPeptideModel(chain(4, 2))
    cohorts = {name: build_cohort(s.glucose, s.timepoints, s.cpeptide,
                                  s.ages, s.t2dm, "cpu")
               for name, s in splits.items()}
    return golden, splits, model, cohorts


@pytest.fixture(scope="module")
def golden():
    return _golden()


def _solve(model, golden, cohort, name, kw, dtype=torch.float32):
    """Trajectories ``[N, T]`` of split ``name`` and the solve's success."""
    if dtype == torch.float64:
        cohort = dataclasses.replace(
            cohort, **{f: getattr(cohort, f).double() for f in CASTS})
    nn = torch.as_tensor(golden["nn"], dtype=dtype)
    betas = torch.as_tensor(golden[f"betas_{name}"], dtype=dtype)
    res = simulate_cohort(model, nn, betas, cohort, **kw)
    return res.ys[:, :, 0], res.success


def test_golden_cohort_is_the_committed_cohort(golden):
    g, splits, _, _ = golden
    for name, split in splits.items():
        assert np.array_equal(g[f"types_{name}"], split.types)
        assert g[f"traj_{name}"].shape == (len(split.ages), 5)
        np.testing.assert_allclose(g["timepoints"], split.timepoints)


@pytest.mark.parametrize("solve", list(SOLVES))
@pytest.mark.parametrize("name", ["train", "test"])
def test_trajectories_match_dop853(golden, name, solve):
    g, _, model, cohorts = golden
    kw, bound = SOLVES[solve]
    traj, ok = _solve(model, g, cohorts[name], name, kw)
    assert bool(ok.all())
    delta = np.abs(traj.numpy() - g[f"traj_{name}"])
    assert delta.max() < bound, (name, solve, delta.max())


@pytest.mark.parametrize("name", ["train", "test"])
def test_sse_within_one_percent(golden, name):
    """Mean and per-type SSE of default-tolerance solves (Tsit5, rtol 1e-3,
    the reference's) within 1 % of the DOP853 values."""
    g, splits, model, cohorts = golden
    traj, _ = _solve(model, g, cohorts[name], name, dict(solver="tsit5"))
    sse = ((traj - cohorts[name].cpeptide) ** 2).sum(1).double().numpy()
    sse_gold, types = g[f"sse_{name}"], splits[name].types
    assert abs(sse.mean() / sse_gold.mean() - 1.0) < 0.01
    for kind in ("NGT", "IGT", "T2DM"):
        sel = types == kind
        assert sel.any()
        assert abs(sse[sel].mean() / sse_gold[sel].mean() - 1.0) < 0.01, kind


def deltas(golden) -> dict:
    """Largest |trajectory − DOP853| over both splits of each solve in
    float32 and in float64, and of RK4 against the tight Tsit5 on the test
    split (the solver delta of ``results/exp_parity_metrics.json``, there
    at the refitted β's)."""
    g, _, model, cohorts = golden
    out = {}
    for dtype in (torch.float32, torch.float64):
        trajs = {}
        solves = {k: kw for k, (kw, _) in SOLVES.items()} | TIGHT
        for solve, kw in solves.items():
            worst = 0.0
            for name, cohort in cohorts.items():
                traj, ok = _solve(model, g, cohort, name, kw, dtype)
                assert bool(ok.all())
                trajs[(solve, name)] = traj.double().numpy()
                worst = max(worst, float(np.abs(trajs[(solve, name)]
                                                - g[f"traj_{name}"]).max()))
            out[f"{solve}, {str(dtype)[6:]}"] = worst
        out[f"rk4 vs tight tsit5 on test, {str(dtype)[6:]}"] = float(np.abs(
            trajs[("rk4, 8 substeps", "test")]
            - trajs[("tsit5, rtol 1e-6", "test")]).max())
    return out


def test_float64_solves_split_the_float32_delta(golden):
    """RK4 at 8 substeps and Tsit5 at rtol 1e-6 keep their deltas in
    float64 (within a factor 2): those are the solvers' own errors, and so
    is the RK4-against-tight-Tsit5 delta.  RK4 at 64 substeps reaches
    DOP853 within 1.5e-6 in float64, while float32 stops higher (its
    rounding floor), still 5 times below either float32 delta."""
    d = deltas(golden)
    for solve in ("rk4, 8 substeps", "tsit5, rtol 1e-6"):
        ratio = d[f"{solve}, float64"] / d[f"{solve}, float32"]
        assert 0.5 < ratio < 2.0, (solve, ratio)
    floor = d["rk4, 64 substeps, float32"]
    assert d["rk4, 64 substeps, float64"] < 1.5e-6 < floor
    assert 5 * floor < min(d["rk4, 8 substeps, float32"],
                            d["tsit5, rtol 1e-6, float32"])


if __name__ == "__main__":
    print(json.dumps(deltas(_golden())))

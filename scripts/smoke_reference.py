"""The JAX experiment scripts at ``--smoke`` on the CPU: the metric keys and
the draw-free values that the port's ``--smoke`` runs are held to.

    python scripts/smoke_reference.py [--only exp03 exp04 ...] [--jobs 4]
        [--work build/smoke_reference] [--out scripts/smoke_reference.json]

The raw CSV files are written from the committed ``artifacts/ohashi.npz``
and ``fujita.npz`` (``tests/etl_fixtures.py``), then each script of
``SCRIPTS`` runs as ``python experiments/<script> --smoke --cpu --data-dir
FIXTURE --artifacts TMP/artifacts --results TMP/results``, each in a clean
``TMP`` of its own (so ``artifacts/smoke/`` is empty, as on a clean
checkout), ``--jobs`` of them at a time.  For each experiment the JSON
holds:

* ``keys``: every dotted key path of the metrics (dicts and leaves);
* ``data_only``: the values that depend on no ``jax.random`` draw
  (``DATA_ONLY``: the symbolic refits whole, the counts and the constant
  strings of the others), by dotted path;
* ``ended``, ``rc``, ``seconds`` and, where the script did not end, the
  last lines of its standard error (``why``).

:func:`check` holds a port run's metrics to an entry: the same key paths
but under the timers of ``TIMING`` (each package times its own stages)
and below the keys of ``OPEN`` (which census classes occur and which
leaves are finite depend on what the fit found), and the draw-free
values at ``TOLERANCES``, the limits ``tests/test_torch_symbolic.py`` and
``chip_smoke.py`` hold the full-size fits to.  ``tests/test_torch_smoke_*
.py`` and ``chip_smoke.py``'s smoke path call it.

exp02_seeds runs seeds 11 and 22 and its ``--merge`` (``exp02_seeds`` is a
seed's record, ``exp02_seeds_merge`` the merged metrics); ``replicate`` is
``experiments/exp_replicate.py --script exp01_non_conditional --seeds 11
22 --smoke``.  With ``--only`` the other entries of ``--out`` are kept.
Whole run ~25 min on 8 cores at 4 jobs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]

OUT = REPO / "scripts" / "smoke_reference.json"
WORK = REPO / "build" / "smoke_reference"
SEEDS = ("11", "22")

# name -> (script, its arguments beside the common ones, metrics files
# under results/smoke/ in order, each entry's name)
SCRIPTS = {
    "exp01": ("exp01_non_conditional.py", [], {"exp01": "exp01_metrics"}),
    "exp02": ("exp02_conditional.py", [], {"exp02": "exp02_metrics"}),
    "exp07": ("exp07_covariate.py", [], {"exp07": "exp07_metrics"}),
    "exp02_xl": ("exp02_xl.py", [], {"exp02_xl": "exp02_xl_metrics"}),
    "exp02_seeds": ("exp02_seeds.py", ["--seeds", *SEEDS],
                    {"exp02_seeds": "exp02_seed_11",
                     "exp02_seeds_merge": "exp02_seeds_metrics"}),
    "exp05": ("exp05_less_data.py", [], {"exp05": "exp05_metrics"}),
    "exp03": ("exp03_symreg.py", [], {"exp03": "exp03_metrics"}),
    "exp04": ("exp04_symreg_external.py", [], {"exp04": "exp04_metrics"}),
    "exp_symreg_production": (
        "exp_symreg_production.py", [],
        {"exp_symreg_production": "exp_symreg_production_metrics"}),
    "exp06": ("exp06_saem.py", [], {"exp06": "exp06_metrics"}),
    "exp06a": ("exp06a_saem_symreg.py", [], {"exp06a": "exp06a_metrics"}),
    "exp06b": ("exp06b_saem_discovered.py", [],
               {"exp06b": "exp06b_metrics"}),
    "exp_advi": ("exp_advi.py", [], {"exp_advi": "exp_advi_metrics"}),
    "exp_suppression": ("exp_suppression.py", [],
                        {"exp_suppression": "exp_suppression_metrics"}),
    "replicate": ("exp_replicate.py",
                  ["--script", "exp01_non_conditional", "--seeds", *SEEDS],
                  {"replicate": "replicate_exp01_non_conditional"}),
}
# the dotted paths (prefixes) whose values no jax.random draw reaches;
# "" is the whole metrics
DATA_ONLY = {
    "exp01": ("reference_ude_weights_golden.mse_train_per_point",
              "reference_ude_weights_golden.mse_test_per_point"),
    "exp07": ("spearman_age_note",),
    "exp02_xl": ("config", "selection_note"),
    "exp02_seeds_merge": ("n_seeds", "seeds"),
    "exp05": ("fractions", "n_seeds"),
    "exp03": ("",),
    "exp04": ("",),
    "exp_symreg_production": ("",),
    "exp_advi": ("n_restarts",),
    "exp_suppression": ("test_stage.lambda", "test_stage.n_test"),
    "replicate": ("seeds",),
}
# the timers: a key path through one of these is not compared
# (exp07's screen_anomaly_note explains a timer of the JAX package's runs)
TIMING = frozenset({"stage_seconds", "train_seconds", "train_timings",
                    "joint_seconds", "test_beta_seconds", "seconds",
                    "screen_anomaly_note"})
OPEN = frozenset({"identifiability_census", "identifiability_census_test",
                  "identifiability_census_all", "aggregate"})
# (the first key of a path in which the name occurs, rtol, atol); the
# rest at the fits' parameter limit
TOLERANCES = (("spearman", 0.0, 0.01), ("census", 0.0, 1.0),
              ("sse", 1e-2, 0.0), ("mse", 1e-2, 0.0))
PARAMETER_RTOL = 2e-3


def key_paths(metrics, prefix: str = "") -> list[str]:
    """Every dotted key path of ``metrics`` (nested dicts and leaves)."""
    out = []
    if isinstance(metrics, dict):
        for k, v in metrics.items():
            out.append(prefix + str(k))
            out += key_paths(v, f"{prefix}{k}.")
    return out


def lookup(metrics: dict, dotted: str):
    cur = metrics
    for part in dotted.split(".") if dotted else ():
        cur = cur[part]
    return cur


def entry(metrics: dict, name: str) -> dict:
    return {"keys": sorted(key_paths(metrics)),
            "data_only": {p: lookup(metrics, p)
                          for p in DATA_ONLY.get(name, ())}}


def compared(paths) -> set[str]:
    """The key paths :func:`check` compares."""
    out = set()
    for path in paths:
        parts = path.split(".")
        if not TIMING.intersection(parts) and not OPEN.intersection(
                parts[:-1]):
            out.add(path)
    return out


def close(got, want, path: str) -> bool:
    """``got`` against ``want`` at the tolerance of the key ``path``
    (``/``-separated)."""
    if isinstance(want, (bool, str, type(None))) or isinstance(got, bool):
        return got == want
    if isinstance(want, list):
        return (isinstance(got, list) and len(got) == len(want)
                and all(close(g, w, path) for g, w in zip(got, want)))
    rtol, atol = next(((r, a) for name, r, a in TOLERANCES if name in path),
                      (PARAMETER_RTOL, 0.0))
    if isinstance(want, int):       # subjects and counts
        rtol = 0.0
    return abs(float(got) - float(want)) <= atol + rtol * abs(float(want))


def median_tie(got: dict, want: dict, n: int) -> dict:
    """exp04's ``profile_ci_quantile_subjects`` of the JAX run with its
    median entry replaced where the port picked the other of a tie: the
    median of an even count ``n`` lies midway between the two middle
    subjects, which the packages break differently (the port to the lower
    index, in float64); with 4 subjects those two are the 0.25 and 0.75
    picks, so a median pick that is the other one is held to that pick's
    entry."""
    mid = got.get("0.5", {}).get("subject")
    if n % 2 or mid == want["0.5"]["subject"]:
        return want
    same = [want[q] for q in ("0.25", "0.75") if want[q]["subject"] == mid]
    return {**want, "0.5": same[0]} if same else want


def compare(got, want, path: str, n: int, fails: list[str]) -> None:
    """Append to ``fails`` what in ``got`` misses ``want`` (``n``: the
    subjects of exp04's quantile picks)."""
    if isinstance(want, dict):
        if not isinstance(got, dict):
            fails.append(f"{path}: {got!r}, JAX a dict")
            return
        if path.endswith("profile_ci_quantile_subjects"):
            want = median_tie(got, want, n)
        for k, w in want.items():
            if k not in got:
                fails.append(f"{path}/{k} missing")
            else:
                compare(got[k], w, f"{path}/{k}", n, fails)
    elif not close(got, want, path):
        fails.append(f"{path}: {got!r}, JAX {want!r}")


def check(name: str, metrics: dict, entry: dict) -> list[str]:
    """What in ``metrics``, a port run's, misses the JAX run's ``entry``."""
    if not entry.get("ended"):
        return [f"{name}: the JAX reference did not end"]
    fails = []
    got, want = compared(key_paths(metrics)), compared(entry["keys"])
    if got != want:
        fails.append(f"keys missing {sorted(want - got)}, extra "
                     f"{sorted(got - want)}")
    for prefix, value in entry["data_only"].items():
        try:
            here = lookup(metrics, prefix)
        except (KeyError, TypeError):
            fails.append(f"{prefix} missing")
            continue
        compare(here, value, prefix.replace(".", "/"),
                metrics.get("n_subjects", 1), fails)
    return [f"{name}: {f}" for f in fails]


def fixture(work: Path) -> Path:
    """The raw CSV files, written from the committed npz."""
    from etl_fixtures import write_fujita_csv, write_ohashi_csvs

    data = work / "data"
    shutil.rmtree(data, ignore_errors=True)
    write_ohashi_csvs(data)
    write_fujita_csv(data)
    return data


def run(name: str, data: Path, work: Path) -> dict:
    script, extra, files = SCRIPTS[name]
    tmp = work / name
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    results = tmp / "results"
    common = ["--results", str(results), "--smoke"]
    if name == "replicate":
        common += ["--scratch", str(tmp / "scratch")]
        cmds = [[*extra, *common, "--", "--cpu", "--data-dir", str(data)]]
    else:
        common += ["--artifacts", str(tmp / "artifacts"), "--cpu",
                   "--data-dir", str(data)]
        cmds = [[*common, *extra]]
        if name == "exp02_seeds":
            cmds.append([*common, "--merge"])
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    t0 = time.perf_counter()
    rc, why = 0, None
    for args in cmds:
        proc = subprocess.run(
            [sys.executable, str(REPO / "experiments" / script), *args],
            cwd=REPO, env=env, capture_output=True, text=True)
        (tmp / "stderr.log").open("a").write(proc.stderr)
        rc = proc.returncode
        if rc != 0:
            why = proc.stderr.strip().splitlines()[-15:]
            break
    seconds = time.perf_counter() - t0
    out = {}
    for key, stem in files.items():
        path = results / "smoke" / f"{stem}.json"
        rec = {"ended": rc == 0 and path.exists(), "rc": rc,
               "seconds": seconds, "script": script}
        if path.exists():
            rec.update(entry(json.loads(path.read_text()), key))
        if why is not None:
            rec["why"] = why
        out[key] = rec
    print(f"[smoke_reference] {name}: rc {rc}, {seconds:.1f} s",
          file=sys.stderr, flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", nargs="+", choices=list(SCRIPTS), default=None)
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--work", type=Path, default=WORK)
    p.add_argument("--out", type=Path, default=OUT)
    args = p.parse_args(argv)
    names = args.only or list(SCRIPTS)
    args.work.mkdir(parents=True, exist_ok=True)
    data = fixture(args.work)
    with ThreadPoolExecutor(args.jobs) as pool:
        parts = list(pool.map(lambda n: run(n, data, args.work), names))
    ref = (json.loads(args.out.read_text())
           if args.only and args.out.exists() else {})
    for part in parts:
        ref.update(part)
    args.out.write_text(json.dumps(dict(sorted(ref.items())), indent=1,
                                   default=float) + "\n")
    print(json.dumps({k: v["ended"] for k, v in ref.items()}))


if __name__ == "__main__":
    main()

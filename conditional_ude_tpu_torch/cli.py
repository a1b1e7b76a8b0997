"""Command-line front door of the port (``cude-torch``; counterpart of
``conditional_ude_tpu/cli.py``):

    cude-torch info                 # torch, CUDA and each card's name
    cude-torch list                 # every experiment and what it does
    cude-torch exp 01 [args]        # run an experiment by number or name
    cude-torch exp 02_c --help      # any unique prefix works ('02' alone is
                                    # ambiguous: exp02_conditional, exp02_seeds,
                                    # exp02_xl)

The names are the JAX experiment scripts' stems (``experiments/``), resolved
as the JAX front door resolves them: the exact stem, then ``exp{NAME}_``,
``exp{NAME}`` and ``NAME`` as prefixes.  Each stem maps to the port's own
entry point (``python -m conditional_ude_tpu_torch`` with the flags that
select it, or the replication runner); the remaining arguments go to that
entry point's flags.  exp00 and exp_parity read the reference's raw data
(``--data-dir``; exp_parity's weights are a JLD2 file, which needs h5py).
There is no ``bench``: the port has no benchmark yet.
"""

from __future__ import annotations

import argparse
import sys

# stem -> (the port's arguments; one line on what it does)
EXPERIMENTS = {
    "exp00_prepare_data": (["--experiment", "exp00"],
                           "the ETL of the reference's raw CSVs into "
                           "ohashi.npz and fujita.npz (needs --data-dir and "
                           "--out)"),
    "exp01_non_conditional": (["--experiment", "exp01"],
                              "the non-conditional UDE"),
    "exp02_conditional": (["--experiment", "exp02"],
                          "the conditional UDE: selection, refit, profiles, "
                          "census and outputs"),
    "exp02_seeds": (["--experiment", "exp02_seeds"],
                    "exp02's retrain at several seeds"),
    "exp02_xl": (["--experiment", "exp02", "--xl"],
                 "exp02 on the enlarged multi-start, guarded selection"),
    "exp03_symreg": (["--experiment", "exp03"],
                     "the symbolic model's refits on the Ohashi cohort"),
    "exp04_symreg_external": (["--experiment", "exp04"],
                              "the symbolic model on the Fujita cohort"),
    "exp05_less_data": (["--experiment", "exp05"], "the less-data ablation"),
    "exp06_saem": (["--experiment", "exp06"], "SAEM on the cUDE"),
    "exp06a_saem_symreg": (["--experiment", "exp06a"],
                           "SAEM on the symbolic model"),
    "exp06b_saem_discovered": (["--experiment", "exp06b"],
                               "SAEM on the discovered equation"),
    "exp07_covariate": (["--experiment", "exp02", "--covariate"],
                        "the covariate cUDE (age as a network input)"),
    "exp_advi": (["--experiment", "exp_advi"], "ADVI posteriors of the cUDE"),
    "exp_figures": (["--experiment", "exp_figures"],
                    "the figure gallery (needs --out)"),
    "exp_parity": (["--experiment", "exp_parity"],
                   "the (β, σ) refit at the reference's trained weights "
                   "and the RK4-Tsit5 check (needs --data-dir; JLD2 "
                   "weights, h5py)"),
    "exp_replicate": ([], "an experiment at several seeds, a child process "
                          "a seed (the replication runner)"),
    "exp_suppression": (["--experiment", "exp_suppression"],
                        "the simulated suppression model"),
    "exp_symreg_production": (["--experiment", "symreg_production"],
                              "the discovered equation's refits"),
    "exp_symreg_search": (["--experiment", "exp_symreg_search"],
                          "the GP search for closed-form equations"),
}


def resolve(name: str) -> str:
    """The stem ``name`` selects: exact stem, then a unique match of the
    prefixes ``exp{name}_``, ``exp{name}`` and ``name`` in that order."""
    stems = sorted(EXPERIMENTS)
    if name in EXPERIMENTS:
        return name
    for prefix in (f"exp{name}_", f"exp{name}", name):
        hits = [s for s in stems if s.startswith(prefix)]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise SystemExit(f"ambiguous experiment {name!r}: "
                             + ", ".join(hits))
    raise SystemExit(f"unknown experiment {name!r}; available: "
                     + ", ".join(stems))


def _cmd_info() -> int:
    import torch

    from conditional_ude_tpu_torch import __version__

    print(f"conditional_ude_tpu_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"cards visible: {torch.cuda.device_count()}")
    for i in range(torch.cuda.device_count()):
        print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
    return 0


def _cmd_list() -> int:
    for stem, (argv, doc) in EXPERIMENTS.items():
        print(f"{stem:28s} {doc}")
    return 0


def _run(stem: str, rest: list[str]) -> int:
    """Run the port's entry point of ``stem`` with ``rest``; its exit code."""
    argv, _ = EXPERIMENTS[stem]
    if stem == "exp_replicate":
        from conditional_ude_tpu_torch.replicate import main as entry
    else:
        from conditional_ude_tpu_torch.__main__ import main as entry
    try:
        entry([*argv, *rest])
    except SystemExit as e:    # argparse --help and errors, refusals
        if e.code is None or isinstance(e.code, int):
            return e.code or 0
        print(e.code, file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="cude-torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info", help="torch, CUDA and each card's name")
    sub.add_parser("list", help="every experiment and what it does")
    p_exp = sub.add_parser("exp", help="run an experiment")
    p_exp.add_argument("name", help="number ('01'), stem, or unique prefix")
    p_exp.add_argument("rest", nargs=argparse.REMAINDER,
                       help="arguments for the port's entry point")
    args = parser.parse_args(argv)
    if args.cmd == "info":
        return _cmd_info()
    if args.cmd == "list":
        return _cmd_list()
    return _run(resolve(args.name), args.rest)


if __name__ == "__main__":
    raise SystemExit(main())

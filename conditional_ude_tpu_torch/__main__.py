"""Run the flagship experiment and print its metrics as one JSON line.

    python -m conditional_ude_tpu_torch                 # frozen candidates, on the card
    python -m conditional_ude_tpu_torch --retrain       # train anew, then the same stages
    python -m conditional_ude_tpu_torch --covariate     # exp07: age as a third input
    python -m conditional_ude_tpu_torch --device cpu    # the plain versions, on the CPU
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from conditional_ude_tpu_torch.pipeline import (
    SEED,
    run_frozen_pipeline,
    run_training_pipeline,
)

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--artifacts", type=Path, default=ARTIFACTS,
                   help="directory holding ohashi.npz and the trained "
                        "candidates (cude_neural_parameters.npz, "
                        "cude_covariate_neural_parameters.npz)")
    p.add_argument("--lbfgs-iters", type=int, default=1000)
    p.add_argument("--retrain", action="store_true",
                   help="train the candidates with train_conditional on the "
                        "seed's fit split instead of loading them")
    p.add_argument("--covariate", action="store_true",
                   help="the covariate model of experiment 07: the age as "
                        "the network's third input (combines with "
                        "--retrain)")
    p.add_argument("--seed", type=int, default=SEED,
                   help="seed of the fit/validation split and the training "
                        "designs (--retrain)")
    args = p.parse_args(argv)
    if args.retrain:
        result = run_training_pipeline(args.device, args.artifacts,
                                       seed=args.seed,
                                       lbfgs_iters=args.lbfgs_iters,
                                       covariate=args.covariate)
    else:
        result = run_frozen_pipeline(args.device, args.artifacts,
                                     lbfgs_iters=args.lbfgs_iters,
                                     covariate=args.covariate)
    print(json.dumps(result.metrics()))


if __name__ == "__main__":
    main()

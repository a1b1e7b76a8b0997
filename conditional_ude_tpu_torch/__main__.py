"""Run the frozen-network path and print its metrics as one JSON line.

    python -m conditional_ude_tpu_torch --device cuda
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from conditional_ude_tpu_torch.pipeline import run_frozen_pipeline

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", required=True,
                   help="torch device to run on, e.g. cuda or cpu")
    p.add_argument("--artifacts", type=Path, default=ARTIFACTS,
                   help="directory holding ohashi.npz and "
                        "cude_neural_parameters.npz")
    p.add_argument("--lbfgs-iters", type=int, default=1000)
    args = p.parse_args(argv)
    result = run_frozen_pipeline(args.device, args.artifacts,
                                 lbfgs_iters=args.lbfgs_iters)
    print(json.dumps(result.metrics()))


if __name__ == "__main__":
    main()

"""``python -m conditional_ude_tpu_torch.parallel [--device cpu --shards K]``:
:func:`~conditional_ude_tpu_torch.parallel.dryrun.dryrun_mesh` on every
card (a 2-way mesh of ``cuda:0`` on one card), or on K copies of the CPU;
prints what it exercised and its seconds as JSON, exits non-zero on any
failure."""

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from conditional_ude_tpu_torch.parallel.dryrun import dryrun_mesh
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--shards", type=int, default=2,
                   help="CPU shards with --device cpu")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    report = dryrun_mesh(None if args.device == "cuda"
                         else ["cpu"] * args.shards)
    report["seconds"] = time.perf_counter() - t0
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

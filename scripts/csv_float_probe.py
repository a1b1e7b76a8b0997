"""Where pandas' CSV float parser and Python's ``float`` part.

The JAX package reads the raw CSV files with ``pandas.read_csv``, whose
default C parser is not always correctly rounded; the port's readers
(``conditional_ude_tpu_torch/data/ohashi.py``) use ``float``, which is.
This writes random positive numbers at several significant-digit counts,
parses them both ways, and prints one JSON line a count: the strings that
parse apart, the largest gap in ulps and a string at that gap.  Needs
pandas (the JAX package's dependency; not the port's).

    python scripts/csv_float_probe.py [--n 100000] [--seed 1]
"""

from __future__ import annotations

import argparse
import io
import json

import numpy as np
import pandas as pd


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    rng = np.random.default_rng(args.seed)
    values = rng.uniform(0, 1000, args.n) * 10.0 ** rng.integers(-8, 8,
                                                                 args.n)
    for fmt in ("%.6g", "%.10g", "%.12g", "%.15g", "repr", "%.17g"):
        strings = [repr(float(v)) if fmt == "repr" else fmt % v
                   for v in values]
        parsed = pd.read_csv(io.StringIO("x\n" + "\n".join(strings))
                             )["x"].to_numpy()
        exact = np.array([float(s) for s in strings])
        ulps = np.abs(parsed.view(np.int64) - exact.view(np.int64))
        print(json.dumps({"digits": fmt, "apart": int((ulps > 0).sum()),
                          "of": args.n, "max_ulps": int(ulps.max()),
                          "at": strings[int(np.argmax(ulps))]
                          if ulps.max() else None}))


if __name__ == "__main__":
    main()

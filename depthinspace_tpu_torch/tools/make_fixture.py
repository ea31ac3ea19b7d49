"""Generate a procedural plane-scene dataset (``data/fixture.py``), port of
``depthinspace_tpu/tools/make_fixture.py``:

  python -m depthinspace_tpu_torch.tools.make_fixture <out_dir> [--n 8]
      [--imsize 64 56] [--seed 42]

Writes settings.pkl and per sample frames.hdf5 and flow.hdf5 in the
reference's schema, with numpy alone, for smoke training and tests.
"""

from __future__ import annotations

import argparse

from ..data.fixture import generate_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--imsize", type=int, nargs=2, default=(64, 56))
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    generate_dataset(args.out_dir, n_samples=args.n,
                     imsize=tuple(args.imsize), seed=args.seed)
    print(f"wrote {args.n} samples to {args.out_dir}")


if __name__ == "__main__":
    main()

"""Build the wire-format dataset cache (``data/cache.py``), port of
``depthinspace_tpu/tools/build_cache.py``:

  python -m depthinspace_tpu_torch.tools.build_cache [--data_dir DIR]
      [--fields im,ambient,disp,R,t] [--force]

Run it after the dataset is made, and with ``--fields primary_disp``
(``pseudo_gt``) to add a presave stage's output; ``presave_disp`` refreshes
a field that is already cached. It reads the HDF5 files with numpy on the
host, as the JAX tool does, and uses no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import load_paths
from ..data.cache import BASE_FIELDS, build_wire_cache


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--fields", default=",".join(BASE_FIELDS))
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    data_dir = Path(args.data_dir or load_paths()["DATA_DIR"])
    fields = [f for f in args.fields.split(",") if f]
    cache = build_wire_cache(data_dir, fields=fields, progress=True,
                             force=args.force)
    print(f"wire cache ready at {cache} (fields: {', '.join(fields)})")


if __name__ == "__main__":
    main()

"""Standalone re-plot CLI (reference plot_acc_and_loss.py): regenerate
training-curve txt exports and PNGs from an experiment's res.res.

  python -m tpukaldi_torch.tools.plot_acc_and_loss <out_folder>
"""

from __future__ import annotations

import os
import sys

from .metrics import create_curves, export_txt


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    out_folder = argv[0]
    res = os.path.join(out_folder, "res.res")
    if not os.path.exists(res):
        print(f"no res.res in {out_folder}", file=sys.stderr)
        return 1
    for path in export_txt(res, out_folder) + create_curves(res, out_folder):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())

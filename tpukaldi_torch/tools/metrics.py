"""Training-curve export and plotting (reference utils.py:2495-2614
`export_loss_acc_to_txt` / `create_curves`, plot_acc_and_loss.py).

Parses res.res epoch lines into arrays, writes the per-metric txt files the
reference emits (train_loss.txt, train_acc.txt, valid_*_loss/acc.txt) and
renders loss/accuracy PNGs with matplotlib when available.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

_EPOCH_RE = re.compile(
    # tr= carries the train_with list repr, which contains spaces for
    # multi-dataset training (["a", "b"]) — match the bracketed form or a
    # single bare token
    r"ep=(\d+)\s+tr=(?:\[.*?\]|\S+)\s+loss=([\d.]+)\s+err=([\d.]+)(.*)"
)
_VALID_RE = re.compile(r"valid=(\S+)\s+loss=([\d.]+)\s+err=([\d.]+)")
_LR_RE = re.compile(r"lr_(\S+)=([\d.eE+-]+)")
_TIME_RE = re.compile(r"time\(s\)=(\d+)")


def parse_res(res_file: str) -> Dict:
    """res.res -> {train_loss, train_err, valid: {name: {loss, err}},
    lr: {arch: [..]}, time: [..]}."""
    out = {
        "epochs": [],
        "train_loss": [],
        "train_err": [],
        "valid": {},
        "lr": {},
        "time": [],
        "wer": [],
    }
    with open(res_file) as f:
        for line in f:
            if line.startswith("%WER"):
                m = re.search(r"%WER\s+([\d.]+)", line)
                if m:
                    out["wer"].append(float(m.group(1)))
                continue
            m = _EPOCH_RE.match(line.strip())
            if not m:
                continue
            out["epochs"].append(int(m.group(1)))
            out["train_loss"].append(float(m.group(2)))
            out["train_err"].append(float(m.group(3)))
            rest = m.group(4)
            for name, loss, err in _VALID_RE.findall(rest):
                v = out["valid"].setdefault(name, {"loss": [], "err": []})
                v["loss"].append(float(loss))
                v["err"].append(float(err))
            for arch, lr in _LR_RE.findall(rest):
                out["lr"].setdefault(arch, []).append(float(lr))
            t = _TIME_RE.search(rest)
            if t:
                out["time"].append(int(t.group(1)))
    return out


def export_txt(res_file: str, out_dir: str) -> List[str]:
    """Write per-metric txt files (one value per epoch, reference
    utils.py:2495-2531)."""
    data = parse_res(res_file)
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def dump(name, values):
        path = os.path.join(out_dir, name + ".txt")
        with open(path, "w") as f:
            f.writelines(f"{v}\n" for v in values)
        written.append(path)

    dump("train_loss", data["train_loss"])
    dump("train_acc", [1.0 - e for e in data["train_err"]])
    for name, v in data["valid"].items():
        dump(f"valid_{name}_loss", v["loss"])
        dump(f"valid_{name}_acc", [1.0 - e for e in v["err"]])
    return written


def create_curves(res_file: str, out_dir: str) -> List[str]:
    """Render loss/accuracy PNGs; returns paths ([] if matplotlib absent)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []
    data = parse_res(res_file)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for metric, title in (("loss", "Loss"), ("err", "Error")):
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.plot(data["epochs"], data[f"train_{metric}"], label="train")
        for name, v in data["valid"].items():
            ax.plot(data["epochs"], v[metric], label=f"valid {name}")
        ax.set_xlabel("epoch")
        ax.set_ylabel(title)
        ax.legend()
        ax.grid(alpha=0.3)
        path = os.path.join(out_dir, f"{metric}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def main(argv=None) -> int:
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(
            "usage: python -m tpukaldi_torch.tools.metrics <res.res> [out_dir]"
        )
        return 2
    res = argv[0]
    out_dir = argv[1] if len(argv) > 1 else os.path.dirname(res) or "."
    print("\n".join(export_txt(res, out_dir)))
    print("\n".join(create_curves(res, out_dir)))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

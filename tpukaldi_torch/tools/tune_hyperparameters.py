"""Random-search hyperparameter tuner (reference tune_hyperparameters.py).

Generates N randomized cfg files from a base cfg:

  python -m tpukaldi_torch.tools.tune_hyperparameters base.cfg out_dir 10 \\
      "arch_lr=randfloat(0.001,0.01)" "batch_size_train=randint(32,256)" \\
      "dnn_act=choose_str{relu,...,softmax|tanh,...,softmax}"

Samplers: randint(lo,hi), randfloat(lo,hi), choose_str{a|b|...},
choose_int{...}, choose_float{...} — same grammar as the reference
(tune_hyperparameters.py:54-74), applied per matching `field=` line with
out_folder rewritten per experiment.
"""

from __future__ import annotations

import os
import random
import re
import sys
from typing import List


def sample_value(spec: str, rng: random.Random):
    if "randint" in spec:
        lo, hi = re.search(r"randint\((.+?)\)", spec).group(1).split(",")
        return rng.randint(int(lo), int(hi))
    if "randfloat" in spec:
        lo, hi = re.search(r"randfloat\((.+?)\)", spec).group(1).split(",")
        return rng.uniform(float(lo), float(hi))
    m = re.search(r"\{(.+?)\}", spec)
    if m is None:
        raise ValueError(f"bad hyperparameter spec {spec!r}")
    choice = rng.choice(m.group(1).split("|"))
    if "choose_int" in spec:
        return int(choice)
    if "choose_float" in spec:
        return float(choice)
    return choice


def generate_tuning_cfgs(
    cfg_file: str,
    output_folder: str,
    n_exp: int,
    hyperparams: List[str],
    seed: int = 1234,
) -> List[str]:
    os.makedirs(output_folder, exist_ok=True)
    rng = random.Random(seed)
    specs = {h.split("=")[0]: h for h in hyperparams}
    out_paths = []
    with open(cfg_file) as f:
        base_lines = f.readlines()
    for i in range(n_exp):
        out_path = os.path.join(output_folder, f"exp{i}.cfg")
        with open(out_path, "w") as out:
            for line in base_lines:
                key = line.split("=")[0].strip()
                if key == "out_folder":
                    out.write(f"out_folder = {output_folder}/exp{i}\n")
                elif key in specs:
                    out.write(f"{key} = {sample_value(specs[key], rng)}\n")
                else:
                    out.write(line)
        out_paths.append(out_path)
    return out_paths


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 4:
        print(__doc__)
        return 2
    paths = generate_tuning_cfgs(argv[0], argv[1], int(argv[2]), argv[3:])
    for p in paths:
        print(p)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""tpukaldi_torch — the PyTorch/CUDA port of tpukaldi.

It reads the same INI cfgs, plans with the same chunk ledger and writes the
same prior-normalised posterior arks as tpukaldi, whose JAX package stays
the reference.  The config, planner, data plane, ark I/O and decode bridge
are tpukaldi's own JAX-free modules, imported, not copied.  The port never
imports JAX.

Layout (mirrors tpukaldi/):
  tools/    run_exp (forward stage), synthetic Kaldi tree
  graph/    [model] DSL -> program over nn.Modules
  models/   MLP and liGRU in the reference state_dict layout
  kernels/  hand-written CUDA kernels for Hopper, each beside its plain version
  train/    chunk runtime, forward step, tpukaldi-format checkpoints
  compat/   weights between tpukaldi trees and port state_dicts
"""

__version__ = "0.1.0"

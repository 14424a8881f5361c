"""tpukaldi_torch — the PyTorch/CUDA port of tpukaldi.

It reads the same INI cfgs, plans with the same chunk ledger and writes the
same prior-normalised posterior arks as tpukaldi, whose JAX package stays
the reference.  The port imports torch and nothing of tpukaldi, not even
the modules there that need no JAX: the config, planner, data plane, ark
I/O, native host ops and decode bridge are the port's own copies, under
the same sub-package names.  The port never imports JAX.

Layout (mirrors tpukaldi/):
  tools/    run_exp (training and forward), run_chunk, the serving export,
            synthetic Kaldi trees
  graph/    [model] DSL -> program over nn.Modules
  models/   MLP, liGRU, LSTM, GRU and QLSTM in the reference state_dict
            layout
  kernels/  hand-written CUDA kernels for Hopper, each beside its plain version
  train/    chunk runtime, forward step, tpukaldi-format checkpoints
  compat/   weights between tpukaldi trees and port state_dicts, reference
            .pkl checkpoints (with their optimizer state) to .ckpt files
  dist/     data parallelism over torch.distributed (one process a card)
  config/, plan/, io/, native/, data/, forward/, decode/
            the host side: cfgs, the chunk plan, Kaldi I/O and host data
            ops, batches, posterior arks, the Kaldi decode bridge
"""

__version__ = "0.1.0"

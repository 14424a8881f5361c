"""The train, eval and forward steps over the compiled graph (counterpart of
tpukaldi's `train/step.py`: `make_train_step`, `make_eval_step`,
`make_forward_step`; reference core.py:614-642).

Loss and err come back as device tensors: nothing here calls `.item()`, so
a step does not wait for the device (tpukaldi fetches the stats once per
chunk, `chunk_runtime.py:615-650`, and so does the port's runtime).

`compute_dtype` (None or `torch.bfloat16`: tpukaldi's mixed-precision
mode, `[exp] compute_dtype` / `TPUKALDI_COMPUTE_DTYPE`) follows tpukaldi's
rule, not `torch.autocast`'s op lists: inside the differentiated forward
every floating parameter but SincNet's cut-offs (`_CAST_EXEMPT`) is cast to
bf16, and the features too (`_cast_compute`); the modules run on the cast
tensors (`graph/compiler.py::apply_graph`'s `params`), so autograd
accumulates the bf16 gradients into the float32 masters, which the
optimizers step.  The master weights, the optimizer state, the batchnorm
statistics and the loss stay float32: the models pin softmax, layer- and
batch-norm moments to float32 and the costs average in float32; the
recurrence kernels widen bf16 at their boundary (K4 reads a bf16 ff
itself).  Forward outputs come back float32.

`make_train_multistep` and `make_eval_multistep` are the counterparts of
tpukaldi's K-step fused dispatch: where tpukaldi scans K same-shape steps
in one jitted call, the port captures one step of a batch shape into a CUDA
graph (`StepGraph`) and replays it for each batch of the group, one host
call a step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from ..dist.mesh import DataParallelMesh, all_reduce_grads, reduce_weighted
from ..graph.compiler import GraphSpec, apply_graph
from ..kernels import _launch
from ..models.common import global_batch_moments
from .optimizers import ArchOptimizer

# parameter names (substrings) kept float32 in the bf16 compute mode, as
# tpukaldi keeps them (`train/step.py::_CAST_EXEMPT`): SincNet's cut-offs,
# whose range (up to the Nyquist frequency) bf16's ~3 digits would
# quantize, and whose consumer synthesises the filters in float32 anyway
_CAST_EXEMPT = ("low_hz", "band_hz")

# the raw-wave front ends that have no bf16 compute mode: tpukaldi's fail
# in it (logMelFb's `jnp.fft.rfft` refuses a bf16 input; PASE's float32
# sinc filters meet a bf16 signal in `lax.conv_general_dilated`)
BF16_REFUSED = ("logMelFb", "PASE")


def refuse_bf16_front_ends(class_names, compute_dtype) -> None:
    """Raise NotImplementedError, naming the class and the dtype, when a
    run that computes in `compute_dtype` (None: float32) uses one of
    `BF16_REFUSED`; the runtime calls it before any output is written."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return
    for name in class_names:
        if name in BF16_REFUSED:
            raise NotImplementedError(
                f"{name} has no {compute_dtype} compute mode (tpukaldi's "
                f"fails in it); run it with compute_dtype = float32")


def _cast_compute(graph: GraphSpec, feats: torch.Tensor, compute_dtype
                  ) -> Tuple[Optional[Dict[str, Dict[str, torch.Tensor]]],
                             torch.Tensor]:
    """tpukaldi's `_cast_compute`: (arch -> {parameter name: its cast}, the
    cast features).  Each floating parameter is cast to `compute_dtype`
    unless its name holds one of `_CAST_EXEMPT`; None (or float32) casts
    nothing and gives (None, feats).  Called inside the differentiated
    forward, so the casts' backward hands float32 gradients to the
    masters."""
    if compute_dtype is None or compute_dtype == torch.float32:
        return None, feats
    params = {
        arch: {name: (p.to(compute_dtype) if p.is_floating_point() and not any(
                   sub in name for sub in _CAST_EXEMPT) else p)
               for name, p in module.named_parameters()}
        for arch, module in graph.modules.items()}
    return params, feats.to(compute_dtype)


def train_step(
    graph: GraphSpec,
    optimizers: Dict[str, ArchOptimizer],
    feats: torch.Tensor,
    labs: torch.Tensor,
    n_valid_t: Union[int, torch.Tensor, None] = None,
    generator: Optional[torch.Generator] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh: Optional[DataParallelMesh] = None,
    weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on `loss_final`: forward in train mode (frozen
    architectures in eval mode), backward, then a step of every unfrozen
    architecture's optimizer.  No `lengths`: tpukaldi's train step passes
    none, so bidirectional layers flip the whole bucket-padded batch.
    `generator` (on the graph's device) draws the dropout masks.
    Returns (loss, err) as detached device scalars.

    Under a process group (`mesh` active) `feats` and `labs` are this
    rank's shard of the batch and `weight` its share of the batch's rows
    (`dist.shard_weight`): the loss is weighted before the backward, the
    unfrozen architectures' gradients are summed over the ranks before the
    optimizers' clip and step, and (loss, err) come back as the global
    batch's.  At world size > 1 batchnorm takes the global batch's
    moments."""
    dp = mesh is not None and mesh.active
    for opt in optimizers.values():
        opt.zero_grad()
    with global_batch_moments(dp and mesh.world_size > 1):
        params, feats = _cast_compute(graph, feats, compute_dtype)
        outs = apply_graph(graph, feats, labs, train=True, to_do="train",
                           n_valid_t=n_valid_t, generator=generator,
                           params=params)
        loss = outs["loss_final"]
        (loss * weight if weight != 1.0 else loss).backward()
    stepped = {name: opt for name, opt in optimizers.items()
               if not graph.archs[name].freeze}
    if dp:
        all_reduce_grads(stepped, mesh=mesh)
    for opt in stepped.values():
        opt.step()
    loss, err = loss.detach(), outs["err_final"].detach()
    if dp:
        loss, err = _global_stats(loss, err, weight, mesh)
    return loss, err


def _global_stats(loss, err, weight, mesh):
    """(loss, err) of the global batch: each rank's weighted by its share,
    summed over the ranks in one all-reduce."""
    both = reduce_weighted(torch.stack([loss.float(), err.float()]), weight,
                           mesh)
    return both[0], both[1]


def eval_step(
    graph: GraphSpec,
    feats: torch.Tensor,
    labs: torch.Tensor,
    n_valid_t: Union[int, torch.Tensor, None] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh: Optional[DataParallelMesh] = None,
    weight: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, err) of a validation batch, every architecture in eval mode;
    under a process group those of the global batch, from this rank's
    shard and its `weight` (as `train_step`)."""
    with torch.inference_mode():
        params, feats = _cast_compute(graph, feats, compute_dtype)
        outs = apply_graph(graph, feats, labs, train=False, to_do="valid",
                           n_valid_t=n_valid_t, params=params)
        loss, err = outs["loss_final"], outs["err_final"]
        if mesh is not None and mesh.active:
            loss, err = _global_stats(loss, err, weight, mesh)
        return loss, err


class StepGraph:
    """One train or eval step captured into a CUDA graph for one batch shape.

    The batch reaches the graph through static device buffers (`feats`,
    `labs` and, for a sequence model, `n_valid_t` as a 0-d int32 tensor,
    as tpukaldi passes `n_valid_k`): `load` copies a pinned host batch, or
    one the device cache assembled, into them without blocking, `replay` runs the step and returns copies of its
    loss and err, which the next replay overwrites.  A train graph draws
    its dropout masks from `generator`, registered with the graph, so a
    replay after `generator.manual_seed(s)` draws what an eager step after
    the same call draws.

    Capture runs no step on the device but runs the step's Python: the
    kernels' launch counters and the optimizers' step counts move once.
    `capture` keeps those moves as the graph's deltas, takes them back, and
    each replay adds them.  A capture or replay that fails raises."""

    def __init__(self, graph: GraphSpec, train: bool, feats: torch.Tensor,
                 labs: torch.Tensor, seq: bool, device,
                 optimizers: Optional[Dict[str, ArchOptimizer]] = None,
                 generator: Optional[torch.Generator] = None, pool=None,
                 compute_dtype: Optional[torch.dtype] = None,
                 mesh: Optional[DataParallelMesh] = None,
                 weight: float = 1.0):
        self.device = torch.device(device)
        self.mesh, self.weight = mesh, weight
        self.graph, self.train = graph, train
        self.compute_dtype = compute_dtype
        self.optimizers = optimizers if train else {}
        self.generator = generator if train else None
        self.feats = torch.empty(feats.shape, dtype=feats.dtype,
                                 device=self.device)
        self.labs = torch.empty(labs.shape, dtype=labs.dtype,
                                device=self.device)
        self.n_valid_t = (torch.zeros((), dtype=torch.int32,
                                      device=self.device) if seq else None)
        self.cuda_graph = torch.cuda.CUDAGraph()
        self.pool = pool
        self.loss = self.err = None
        self.deltas: Dict = {}
        self.count_deltas: Dict[str, int] = {}

    def load(self, feats: torch.Tensor, labs: torch.Tensor,
             n_valid_t: Optional[int]) -> None:
        """The batch into the static buffers, in stream order: `feats` and
        `labs` are pinned host tensors (the copies do not block the host)
        or tensors on the device (the device cache's gather)."""
        self.feats.copy_(feats, non_blocking=True)
        self.labs.copy_(labs, non_blocking=True)
        if self.n_valid_t is not None:
            self.n_valid_t.fill_(n_valid_t if n_valid_t is not None
                                 else feats.shape[0])

    def _step(self):
        if self.train:
            return train_step(self.graph, self.optimizers, self.feats,
                              self.labs, self.n_valid_t, self.generator,
                              self.compute_dtype, self.mesh, self.weight)
        return eval_step(self.graph, self.feats, self.labs, self.n_valid_t,
                         self.compute_dtype, self.mesh, self.weight)

    def capture(self, stream: torch.cuda.Stream) -> None:
        """Capture the step on `stream` (not the current one: a capture
        needs a stream of its own), in `thread_local` mode, so that the
        prefetch thread's pinning and the checkpoint writer's copies on
        other threads go on during it.  Waits for the device first."""
        counters = _launch.read_counters()
        counts = {n: o.count for n, o in self.optimizers.items()}
        if self.generator is not None:
            self.cuda_graph.register_generator_state(self.generator)
        current = torch.cuda.current_stream(self.device)
        # a capture can neither free cached blocks (cudaFree) nor take
        # the other pools' free ones: free them first, as
        # `torch.cuda.graph` does
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.cuda_graph.capture_begin(pool=self.pool,
                                          capture_error_mode="thread_local")
            try:
                self.loss, self.err = self._step()
            except BaseException:
                # leave capture mode; the step's error says why it failed
                try:
                    self.cuda_graph.capture_end()
                except BaseException:
                    pass
                raise
            self.cuda_graph.capture_end()
        current.wait_stream(stream)
        after = _launch.read_counters()
        self.deltas = {k: after[k] - counters[k] for k in after}
        _launch.add_counters({k: -d for k, d in self.deltas.items()})
        self.count_deltas = {n: o.count - counts[n]
                             for n, o in self.optimizers.items()}
        for n, o in self.optimizers.items():
            o.count = counts[n]

    def replay(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run the captured step on the current stream; (loss, err) copied
        on the device before the next replay overwrites them."""
        self.cuda_graph.replay()
        _launch.add_counters(self.deltas)
        for n, d in self.count_deltas.items():
            self.optimizers[n].count += d
        return self.loss.clone(), self.err.clone()


def make_train_multistep(graph: GraphSpec,
                         optimizers: Dict[str, ArchOptimizer],
                         feats: torch.Tensor, labs: torch.Tensor, seq: bool,
                         device, generator: torch.Generator,
                         pool=None, compute_dtype=None, mesh=None,
                         weight: float = 1.0) -> StepGraph:
    """A train step on `device` for batches shaped as `feats` and `labs`,
    to capture (tpukaldi's `make_train_multistep`: K steps in one
    dispatch); under an NCCL group (`mesh`) the graph holds the step's
    all-reduces."""
    return StepGraph(graph, True, feats, labs, seq, device, optimizers,
                     generator, pool, compute_dtype, mesh, weight)


def make_eval_multistep(graph: GraphSpec, feats: torch.Tensor,
                        labs: torch.Tensor, seq: bool, device,
                        pool=None, compute_dtype=None, mesh=None,
                        weight: float = 1.0) -> StepGraph:
    """An eval step on `device` for batches shaped as `feats` and `labs`,
    to capture (tpukaldi's `make_eval_multistep`)."""
    return StepGraph(graph, False, feats, labs, seq, device, pool=pool,
                     compute_dtype=compute_dtype, mesh=mesh, weight=weight)


def forward_step(
    graph: GraphSpec,
    feats: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    log_priors: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    pack_idx: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """Posteriors for one utterance batch, each flattened to (T*B, C).

    `lengths` makes bucket-padded utterances exact for bidirectional
    models.  `log_priors` (out_name -> float32 tensor on the graph's device,
    or None) subtracts `log(counts/sum(counts))` (reference core.py:665-668)
    on the device.  `pack_idx` (N,) gathers the rows of real frames before
    the caller copies the result to the host, so padding never crosses.
    """
    with torch.inference_mode():
        return forward_outputs(graph, feats, lengths, log_priors, pack_idx,
                               compute_dtype)


def forward_outputs(
    graph: GraphSpec,
    feats: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    log_priors: Optional[Dict[str, Optional[torch.Tensor]]] = None,
    pack_idx: Optional[torch.Tensor] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> Dict[str, torch.Tensor]:
    """`forward_step`'s computation in the caller's grad mode (the serving
    export traces it under `torch.no_grad`)."""
    params, feats = _cast_compute(graph, feats, compute_dtype)
    outs = apply_graph(graph, feats, None, train=False, to_do="forward",
                       lengths=lengths, params=params)
    result = {}
    for name in graph.forward_outs:
        # posteriors are float32 in every compute dtype
        o = outs[name].float()
        prior = (log_priors or {}).get(name)
        if prior is not None:
            o = o - prior
        o = o.reshape(o.shape[0] * o.shape[1], -1) if o.ndim == 3 else o
        if pack_idx is not None:
            o = o.index_select(0, pack_idx)
        result[name] = o
    return result

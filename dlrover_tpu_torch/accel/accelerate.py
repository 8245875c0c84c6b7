"""``auto_accelerate`` — train-step assembly for the port.

Counterpart of ``dlrover_tpu/accel/accelerate.py``. The JAX version
picks a ``ParallelSpec`` (mesh degrees), shards the state over a mesh
and jits one SPMD step. PyTorch runs eagerly, so the "step" is a plain
function over live modules: forward, backward, optimizer update.

A one-device spec (``ParallelSpec()``, or ``"auto"`` in a one-process
job) trains the module as it is. A spec of several ``data``, ``fsdp``,
``pipe``, ``tensor``, ``seq`` and ``expert`` degrees over a world of as
many processes (one device each: a card under NCCL, the CPU under gloo)
places the module on a ``DeviceMesh`` of those axes
(``accelerate_on_mesh``, also callable on a mesh whose axes have size
1):

- ``pipe``: a model with ``pipeline_stages`` (``accel/pipeline.py``)
  keeps on each rank its block of ``P/R`` stages (bank rows, with all
  their chunks); the first rank keeps the embedding, the last the final
  norm and the head, both GPT's tied ``wte``, whose gradient is summed
  over those two ranks (as Megatron does). The step runs the schedule
  over the ranks, activations passing between neighbours by P2P, the
  loss formed on the last rank and shared with every rank, and the
  backward run tick by tick in reverse (``_Schedule.backward``). A
  pipelined model's microbatch ``i`` is the global rows
  ``[i*mb, (i+1)*mb)``, of which each ``data`` rank takes its slice
  (``local_batch``), as JAX reshapes the batch before sharding it;

- ``tensor``: each ``Dense`` whose logical axes the rules map to the
  tensor axis becomes column- or row-parallel (``tensor_parallel``):
  its kernel a DTensor of its shard, the blocks computing on their
  local heads and ``mlp`` columns; when the vocab divides, the
  embedding's rows are sharded (its lookup sums the ranks' rows) and
  so is the head, LLaMA's untied one and GPT's tied ``wte`` (its
  logits a DTensor sharded along the vocab);
- ``fsdp``: FSDP2's ``fully_shard`` on each block, then on the root,
  every parameter sharded along the dim its ``embed`` axis names, as
  JAX's rules place it (FSDP2's ``shard_placement_fn``); a leaf
  without one (a bias, whose JAX leaf lies whole on fsdp) along dim 0,
  as FSDP2 shards every parameter it holds. With ``tensor`` too,
  FSDP2's 2-D form shards the tensor-parallel DTensors: a kernel's or
  the embedding's two axes take two dims, and where the tensor axis
  already splits dim 0 (a column bias) a rank's rows are the fsdp chunk
  of its tensor chunk (``_StridedShard``);
- ``expert``: each MoE layer's stacks (and its router, along its expert
  columns) DTensors of this rank's experts (``ops/moe.py``); tokens are
  replicated over the axis, as JAX's ``batch`` rule names only data
  and fsdp;
- ``seq``: the model keeps its shard of every row's sequence, GPT's
  position rows are sharded over the axis, attention is ring or
  Ulysses over its group (``models/sequence_parallel.py``), and the
  gradients of the parameters the axis replicates are summed over it
  after the backward;
- ``data``: the gradients all-reduced over the data axis and divided by
  its size after the backward, once a step (the step's own reduction,
  not DDP's wrapper: the parameter names stay the model's, and the
  DTensor kernels of ``tensor`` reduce the same way);
- every process passes the global batch; ``AccelerateResult.local_batch``
  takes this rank's rows (its ``(data, fsdp)`` coordinate) before they
  reach the device, and the step's loss is the mean over all ranks.

A model without ``logical_axes()`` (a plain ``nn.Module``) is placed
by a ``ShardingRegistry`` (``accel/registry.py``), as JAX's ``build``
annotates one: the caller's ``registry=``, else under ``tensor`` (or
``allow_tensor=True``) ``tp_planner.plan_tp``'s from one forward of the
sample batch, else the defaults. Each ``nn.Linear`` the rules put on
the tensor axis becomes a ``ParallelLinear`` (column biases sharded,
row biases replicated; the head whose axis is ``vocab`` gathers its
logits), an ``nn.Embedding`` whose vocab rows they put there a
``VocabParallelEmbedding``, and FSDP2 shards every parameter as it
shards an annotated model's, each block a unit (the items of its
``nn.ModuleList``s, or else its direct children that hold layers).
Any other parameter the rules put on the tensor axis (a conv's
weight, a bare ``nn.Parameter``) is stored as its shard and gathered
whole before its module's forward (``models/tensor_parallel.py``'s
``gather_in_forward``): the module computes on the whole tensor. The
rules are JAX's for a model without ``cfg.vocab_size``: the vocab rule
has no divisibility guard, and a dim the tensor degree does not divide
raises ``ValueError`` at placement, as JAX's jit refuses the split.
Its blocks must take their head count from the local width
(``view(b, s, -1, head_dim)``): a rank's tensors are local, not
DTensors.

An MoE layer on any mesh routes as JAX routes the global batch (capacity
from the global token count, buffer positions offset by the earlier
ranks' tokens). Not yet: ``seq`` or ``expert`` (or an MoE model) with
``fsdp`` or ``tensor``, ``seq`` with ``expert``, ``pipe`` (or a
pipelined model) with ``fsdp``, ``tensor``, ``seq`` or ``expert``, and
a ``seq`` degree above 1 without ring or Ulysses attention raise
``NotImplementedError``.
A ``pipe`` or ``expert`` degree on a model without stages or experts
raises ``ValueError``, as JAX's ``_check_spec_axes_used`` does.

An optimizer with ``update_and_apply`` (``adam8bit``,
``bf16_master_weights``) keeps its state whole and replicated, as the
JAX package's 8-bit Adam does: ``MeshOptimizer`` gathers each sharded
leaf's gradient and parameter, updates the whole leaf, and writes back
this rank's shard. On pipe ranks nothing is gathered: a rank's state is
its stages' and ends' (the 8-bit Adam's table holds its stages' rows of
each leaf, one fused launch a step; GPT's tied ``wte`` is stepped alike
on the first and last rank from its summed gradient). A torch optimizer
(``adamw``, ``agd``) steps the DTensor shards themselves.
``ParallelSpec(data=N, zero=True)`` (ZeRO-1, ``accel/zero.py``), beside
any other axis, slices the optimizer state over the data ranks instead:
each steps its slice of every leaf (cut from its fsdp, tensor, seq or
expert shard, or from its pipe rank's stages) and all-gathers the
updated parameters. ``offload_optimizer=True`` keeps the big leaves of
whichever state a rank holds in host memory between steps
(``optim/offload.py``).

``devices=`` lists one device per rank of the world (a process drives
one): rank ``r`` trains on ``devices[r]``, and ``"auto"`` searches over
``len(devices)`` of them, as JAX's search does.

``spec="auto"`` runs the JAX package's strategy search
(``accel/search.py``) for the world's size and the batch: it ranks the
candidates, reconfigures the model for each (``seq`` switches attention
to the ring, ``pipe`` sets ``pipeline_stages``; the caller's weights are
carried over) and builds the first one the port places, logging the
refusals of those it does not; with ``profile=True`` it first times the
top ``search_top_k`` on copies of the model (every rank takes the
slowest rank's time, so all choose alike). ``AccelerateResult``'s
``search_ranking`` holds the ranking.
"""

import copy
import dataclasses
import itertools
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from dlrover_tpu_torch.accel import sharding
from dlrover_tpu_torch.accel.mesh import axis_sizes, create_mesh
from dlrover_tpu_torch.accel.registry import has_annotations
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.ops.moe import Axis, MoEMLP
from dlrover_tpu_torch.optim.base import bind
from dlrover_tpu_torch.optim.offload import OffloadOptimizer

# The mesh axes this slice places a module on, in the JAX package's order.
MESH_AXES = ("data", "fsdp", "pipe", "seq", "expert", "tensor")
_ITEM6 = ("a later part of ROADMAP queue 1, item 6 (sequence and expert "
          "parallelism's rest: seq or expert beside fsdp or tensor, whose "
          "leaves lie over two mesh axes as fsdp x tensor's do)")
_PIPE_REST = ("a later part of ROADMAP queue 1, item 6 (pipeline "
              "parallelism's rest: pipe with fsdp, tensor, seq or expert, "
              "and the vocab over pipe)")


@dataclass(frozen=True)
class ParallelSpec:
    """Mesh degrees (the JAX package's Strategy object, same fields).
    ``zero`` flags ZeRO-1 optimizer-state sharding over ``data``;
    ``collectives`` maps an axis to its collective algorithm, which has
    a meaning only across devices (a later slice)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1
    zero: bool = False
    collectives: tuple = ()

    def __post_init__(self):
        for name in ("data", "fsdp", "tensor", "seq", "expert", "pipe"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} degree must be >= 1")
        coll = self.collectives
        if isinstance(coll, dict):
            coll = coll.items()
        norm = tuple(sorted(
            (str(axis), str(strategy)) for axis, strategy in (coll or ())
        ))
        for axis, strategy in norm:
            if strategy not in ("bw", "lat"):
                raise ValueError(
                    f"unknown collective strategy {strategy!r} for axis "
                    f"{axis!r} (want 'bw' or 'lat')"
                )
        object.__setattr__(self, "collectives", norm)

    @property
    def total(self) -> int:
        return (self.data * self.fsdp * self.tensor * self.seq
                * self.expert * self.pipe)

    def axes(self):
        return [
            (name, getattr(self, name))
            for name in ("data", "fsdp", "pipe", "seq", "expert", "tensor")
            if getattr(self, name) > 1
        ]

    def rules(self, vocab_size: int = 0, present=()):
        """The JAX package's rules for these degrees; the axes named in
        ``present`` take their rules at size 1 too (a mesh that has
        them)."""
        d = dataclasses.asdict(self)
        # Algorithm choice, not a mesh degree: no logical-axis rule.
        d.pop("collectives", None)
        return sharding.logical_rules(**d, vocab_size=vocab_size,
                                      present=present)


@dataclass
class AccelerateResult:
    spec: ParallelSpec
    device: torch.device
    #: ``{"params": {name: Parameter}, "opt": Optimizer, "step": int}`` —
    #: live objects, updated in place by ``train_step``.
    state: Any
    train_step: Callable          # (state, batch) -> (state, metrics)
    module: nn.Module
    #: The ``DeviceMesh`` of a multi-device spec (None on one device).
    mesh: Any = None
    #: This rank's rows ``(start, stop)`` of each of ``parts`` equal
    #: parts of the global batch's ``rows``: ``((start, stop), rows)``.
    batch_rows: Optional[tuple] = None
    #: The parts: a pipelined model's microbatches (times ``grad_accum``),
    #: of each of which a data rank takes its slice; 1 otherwise.
    parts: int = 1
    #: ``[(ParallelSpec, CostEstimate)]`` of the strategy search, best
    #: first (None for an explicit spec).
    search_ranking: Any = None

    def local_batch(self, batch):
        """This rank's rows of a global batch (a tensor or array, or a
        list, tuple or dict of them), before they go to the device; the
        batch as it is on one device."""
        if self.batch_rows is None:
            return batch
        from dlrover_tpu_torch.train.data.device_prefetch import map_batch

        (lo, hi), rows = self.batch_rows
        parts = self.parts

        def take(x):
            if x.shape[0] != rows:
                raise ValueError(f"a global batch of {x.shape[0]} rows, "
                                 f"want {rows}")
            if parts == 1:
                return x[lo:hi]
            rest = tuple(x.shape[1:])
            return x.reshape((parts, rows // parts) + rest)[:, lo:hi] \
                .reshape((-1,) + rest)

        return map_batch(take, batch)

    def forward_loss(self, loss: Callable, batch) -> torch.Tensor:
        """``loss(module, params, batch)`` of this rank's rows (on the
        device) without a backward; zero on a pipe rank before the last,
        after its share of the forward."""
        return _forward_loss(self.module, loss, self.state["params"], batch)

    @property
    def loss_ranks(self) -> int:
        """The ranks that form the loss: every one, or on a pipe mesh
        those of the last stage (their mean is the global loss)."""
        return _loss_ranks(self.mesh)


def _loss_ranks(mesh) -> int:
    if mesh is None:
        return 1
    return dist.get_world_size() // axis_sizes(mesh).get("pipe", 1)


def _pipeline(module: nn.Module):
    """The module's pipeline schedule when it runs over pipe ranks."""
    pipe = getattr(module, "pipeline", None)
    return pipe if pipe is not None and pipe.distributed else None


def _forward_loss(module: nn.Module, loss: Callable, params, batch):
    pipe = _pipeline(module)
    if pipe is None or pipe.last:
        return loss(module, params, batch)
    module(batch)
    return torch.zeros((), device=batch.device)


def make_train_step(module: nn.Module, loss: Callable, grad_accum: int = 1,
                    mesh=None):
    """The train step: ``step(state, batch) -> (state, {"loss": tensor})``.

    ``loss(module, params, batch) -> scalar``, where ``params`` is the
    module's live parameter dict (so ``module(batch)`` and
    ``torch.func.functional_call(module, params, batch)`` agree).
    ``grad_accum > 1`` splits the leading batch dim into that many
    microbatches, sums their gradients and divides by the count before
    one optimizer update, as the JAX step's scan does. An optimizer with
    ``update_and_apply(grads, params)`` updates the params in place in
    one pass (the fused 8-bit Adam's contract); any other gets
    ``step()``. The loss stays on the device: reading it syncs.

    On a ``mesh`` the batch is this rank's rows: FSDP2 reduces the
    gradients over ``fsdp`` in the last microbatch's backward only
    (``set_requires_gradient_sync``), the step sums those of the
    parameters a ``seq`` axis replicates over it (each seq rank
    differentiates its share of the loss), then averages them over
    ``data``, and the loss it reports is the mean over every rank. Over
    pipe ranks the loss is formed on the last (``loss`` runs there, the
    module alone on the others), the schedule's backward runs on every
    rank after the loss's, the tied head's gradient is summed over the
    first and last ranks, and the reported loss is the mean over the
    last stage's ranks.
    """
    params = dict(module.named_parameters())
    pipe = _pipeline(module)
    tied = [params[n] for n in getattr(module, "TIED", ())
            if pipe is not None and n in params]
    fsdp = [m for m in module.modules() if hasattr(m,
                                                   "set_requires_gradient_sync")]
    names = () if mesh is None else mesh.mesh_dim_names
    data_group = mesh.get_group("data") if "data" in names else None
    data_size = axis_sizes(mesh).get("data", 1) if mesh is not None else 1
    seq_group, seq_replicated = None, []
    if "seq" in names:
        seq_group = mesh.get_group("seq")
        axis = names.index("seq")
        seq_replicated = [p for p in params.values()
                          if sharding.layout_of(p) is None
                          or sharding.layout_of(p).shard[axis] is None]

    loss_ranks = _loss_ranks(mesh)

    def grads_of(batch, sync: bool = True):
        for m in fsdp:
            m.set_requires_gradient_sync(sync, recurse=False)
        lv = _forward_loss(module, loss, params, batch)
        if pipe is None or pipe.last:
            lv.backward()
        if pipe is not None:
            pipe.backward()
        return lv.detach()

    flat: Dict[Any, torch.Tensor] = {}

    def reduce_grads(which, group, divide: Optional[int]):
        """One all-reduce a dtype: the gradients of ``which`` are copied
        into a flat buffer kept from step to step, summed over ``group``,
        divided by ``divide`` (when given) and copied back (a collective
        a tensor costs the host more than the copies cost the card)."""
        groups: Dict[Any, list] = {}
        for p in which:
            if p.grad is not None:
                g = sharding.local(p.grad)
                groups.setdefault((g.dtype, g.device), []).append(g)
        for key, grads in groups.items():
            sizes = [g.numel() for g in grads]
            buf = flat.get((id(group),) + key)
            if buf is None or buf.numel() != sum(sizes):
                buf = flat[(id(group),) + key] = torch.empty(
                    sum(sizes), dtype=key[0], device=key[1])
            views = [v.view(g.shape)
                     for v, g in zip(buf.split(sizes), grads)]
            torch._foreach_copy_(views, grads)
            dist.all_reduce(buf, group=group)
            if divide is not None:
                buf.div_(float(divide))
            torch._foreach_copy_(grads, views)

    def step(state, batch):
        if grad_accum > 1:
            b = batch.shape[0]
            if b % grad_accum:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum {grad_accum}"
                )
            micro = batch.reshape(grad_accum, b // grad_accum,
                                  *batch.shape[1:])
            loss_sum = torch.zeros((), device=batch.device)
            for i, mb in enumerate(micro):
                # .grad sums microbatches; FSDP2 reduces the sum once.
                loss_sum = loss_sum + grads_of(mb, i == grad_accum - 1)
            lv = loss_sum / grad_accum
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
        else:
            lv = grads_of(batch)
        with torch.no_grad():
            if seq_group is not None:
                reduce_grads(seq_replicated, seq_group, None)
            if tied and pipe.ranks.ends is not None:
                reduce_grads(tied, pipe.ranks.ends, None)
            if data_group is not None:
                reduce_grads(params.values(), data_group, data_size)
        if mesh is not None:
            lv = lv.clone()
            dist.all_reduce(lv)
            lv = lv / loss_ranks
        opt = state["opt"]
        fused = getattr(opt, "update_and_apply", None)
        if fused is not None:
            live = [p for p in params.values() if p.grad is not None]
            with torch.no_grad():
                fused([p.grad for p in live], live)
        else:
            opt.step()
        for p in params.values():
            p.grad = None
        state["step"] += 1
        return state, {"loss": lv}

    return step


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _check_spec(spec: Any, carries: Dict[str, bool]) -> ParallelSpec:
    """A spec's degrees must be ones this slice places, on axes a model
    that ``carries`` stages or experts (``_carries``) uses, over a world
    of as many processes."""
    if not isinstance(spec, ParallelSpec):
        raise TypeError(f"spec must be a ParallelSpec or 'auto', got {spec!r}")
    if spec.collectives:
        raise NotImplementedError(
            f"collectives={spec.collectives} (a per-axis all-reduce "
            "algorithm) comes with the comms governor (ROADMAP queue 1, "
            "item 5)")
    _check_axes(dict(spec.axes()))
    _check_spec_axes_used(spec, carries)
    if spec.total > 1 and spec.total != _world_size():
        raise ValueError(f"{spec} needs a world of {spec.total} processes, "
                         f"have {_world_size()}")
    return spec


def _check_axes(sizes: Dict[str, int]):
    """The compositions of mesh axes this slice places (``sizes``: the
    axes present, of any size)."""
    if ("seq" in sizes or "expert" in sizes) and (
            "fsdp" in sizes or "tensor" in sizes):
        raise NotImplementedError(
            "a seq or expert axis together with fsdp or tensor comes with "
            + _ITEM6)
    if "seq" in sizes and "expert" in sizes:
        raise NotImplementedError(
            "seq and expert axes together come with " + _ITEM6)
    if "pipe" in sizes and set(sizes) & {"fsdp", "tensor", "seq", "expert"}:
        raise NotImplementedError(
            "a pipe axis together with fsdp, tensor, seq or expert comes "
            "with " + _PIPE_REST)


def _carries(module: nn.Module) -> Dict[str, bool]:
    """Which logical axes a parameter of ``module`` carries: ``stage``
    (a model with ``pipeline_stages``), ``expert`` (one with experts)."""
    return {"stage": getattr(module, "pipeline", None) is not None,
            "expert": any(isinstance(m, MoEMLP) for m in module.modules())}


def _check_spec_axes_used(spec: ParallelSpec, carries: Dict[str, bool]):
    """JAX's check: a ``pipe`` or ``expert`` degree above 1 with no
    parameter carrying the matching logical axis (``stage``: a model
    with ``pipeline_stages``; ``expert``: one with experts) would
    silently waste those devices, and raises ``ValueError``."""
    for degree, logical in ((spec.pipe, "stage"), (spec.expert, "expert")):
        if degree > 1 and not carries[logical]:
            raise ValueError(
                f"ParallelSpec has {logical!r}-axis degree {degree} but no "
                f"model parameter carries the {logical!r} logical axis — "
                "those devices would be silently wasted. Configure the "
                "model for it (e.g. GPTConfig.pipeline_stages / "
                "num_experts) or drop the degree."
            )


def _check_mesh(sizes: Dict[str, int], carries: Dict[str, bool]):
    """What ``accelerate_on_mesh`` refuses on a mesh of ``sizes`` (the
    axes present, of any size) for a model that ``carries`` stages or
    experts."""
    _check_axes(sizes)
    if carries["stage"] and set(sizes) & {"fsdp", "tensor", "seq",
                                          "expert"}:
        raise NotImplementedError(
            "a pipelined model on an fsdp, tensor, seq or expert axis comes "
            "with " + _PIPE_REST)
    if carries["expert"] and ("fsdp" in sizes or "tensor" in sizes):
        raise NotImplementedError(
            "an MoE model on an fsdp or tensor axis comes with " + _ITEM6)


def _check_candidate(spec: ParallelSpec, cfg, carries: Dict[str, bool],
                     optimizer, rows: int):
    """Whether the port places ``spec`` for a model of ``cfg`` (already
    reconfigured for it) and ``optimizer``: raises what building it
    would raise, before anything is built or any group made."""
    from dlrover_tpu_torch.accel.zero import _sliceable

    if not isinstance(spec, ParallelSpec):
        raise TypeError(f"spec must be a ParallelSpec, got {spec!r}")
    _check_spec(spec, carries)
    if spec.total == 1:
        return
    _check_mesh(dict(spec.axes()), carries)
    if spec.tensor > 1 and cfg is not None:
        counts = {"num_heads": cfg.num_heads, "mlp width": cfg.ff_dim}
        if hasattr(cfg, "kv_heads"):
            counts["num_kv_heads"] = cfg.kv_heads
        for what, n in counts.items():
            if n % spec.tensor:
                raise ValueError(f"{what} {n} does not divide by the tensor "
                                 f"degree {spec.tensor}")
    if spec.zero:
        _sliceable(optimizer)
    shards = spec.data * spec.fsdp
    if rows % shards:
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"over {shards} data/fsdp ranks")


def auto_accelerate(
    module: nn.Module,
    optimizer,
    sample_batch,
    loss: Callable,
    spec: Any = "auto",
    device: DeviceLike = None,
    grad_accum: int = 1,
    offload_optimizer: bool = False,
    precision: str = "bf16",
    profile: bool = False,
    profile_steps: int = 3,
    allow_tensor: Optional[bool] = None,
    search_top_k: int = 4,
    registry=None,
    devices=None,
) -> AccelerateResult:
    """Place the model, bind the optimizer, build the train step.

    ``optimizer`` is unbound (a ``params -> torch.optim.Optimizer``
    factory such as ``dlrover_tpu_torch.optim.adamw(lr)``, the analog of
    an optax transformation) or an optimizer already bound to
    ``module``'s parameters (``optim.base.bind``). ``device`` defaults to
    this worker's card and raises without CUDA; the CPU runs only when
    named. ``offload_optimizer=True`` keeps the optimizer's big state
    leaves in host memory between steps (``optim/offload.py``).

    ``spec`` is a ``ParallelSpec`` or ``"auto"``, the strategy search
    over the world's processes, with the JAX package's arguments:
    ``profile=True`` dry-runs the top ``search_top_k`` candidates for
    ``profile_steps`` steps each and keeps the fastest;
    ``allow_tensor=False`` strips tensor parallelism from the search.
    A model without ``logical_axes()`` is placed on a mesh by
    ``registry`` (a ``ShardingRegistry``), or, with ``allow_tensor=True``
    or a tensor degree, by the planner's; ``allow_tensor=True`` lets the
    search of such a model try tensor degrees, as JAX's does.
    ``devices`` lists one device per rank of the world (a process of the
    port drives one): this rank trains on ``devices[rank]``, ``"auto"``
    searches over ``len(devices)`` devices, and a list of another length
    than the world's, or a ``device`` that is not this rank's entry,
    raises ``ValueError``. ``precision="int8"`` raises, naming the slice
    that brings it.
    """
    if devices is not None:
        device = _device_of_rank(devices, device)
    if precision == "int8":
        raise NotImplementedError(
            'precision="int8" comes with the int8 matmul slice of the port '
            "(ROADMAP queue 1, item 9)")
    if precision != "bf16":
        raise ValueError(f"precision must be 'bf16' or 'int8', got "
                         f"{precision!r}")
    dev = resolve_device(device)
    if isinstance(spec, str):
        if spec != "auto":
            raise ValueError(f"spec must be a ParallelSpec or 'auto', got "
                             f"{spec!r}")
        return _auto(module, optimizer, sample_batch, loss, dev, grad_accum,
                     offload_optimizer, profile, profile_steps, allow_tensor,
                     search_top_k, registry)
    return _build(module, optimizer, sample_batch, loss,
                  _check_spec(spec, _carries(module)), dev, grad_accum,
                  offload_optimizer, registry, allow_tensor)


def _device_of_rank(devices, device: DeviceLike) -> torch.device:
    """This rank's entry of ``devices`` (one device per rank of the
    world), held against ``device`` when that is given too."""
    devices = [torch.device(d) for d in devices]
    n, world = len(devices), _world_size()
    if n != world:
        raise ValueError(f"a world of {world} processes needs {world} "
                         f"devices, have {n}")
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else int(os.environ.get("RANK", "0"))
    mine = devices[rank]
    if device is not None and resolve_device(device) != mine:
        raise ValueError(f"device={device!r} is not devices[{rank}] "
                         f"({mine}), the device of rank {rank}")
    return mine


def _build(module, optimizer, sample_batch, loss, spec: ParallelSpec, dev,
           grad_accum: int, offload_optimizer: bool, registry=None,
           allow_tensor: Optional[bool] = None) -> AccelerateResult:
    """``spec`` (checked) built: on a mesh of its axes, or one device (a
    plain module's registry and planner apply on a mesh only, as in
    JAX)."""
    if spec.total > 1:
        mesh = create_mesh(spec.axes(), dev)
        res = accelerate_on_mesh(
            module, optimizer, sample_batch, loss, mesh, device=dev,
            grad_accum=grad_accum, offload_optimizer=offload_optimizer,
            zero=spec.zero, registry=registry, allow_tensor=allow_tensor)
        res.spec = spec
        return res
    if sample_batch.shape[0] % grad_accum:
        raise ValueError(
            f"batch {sample_batch.shape[0]} not divisible by grad_accum "
            f"{grad_accum}"
        )
    module = module.to(dev)
    opt = bind(optimizer, module.named_parameters())
    if offload_optimizer:
        opt = OffloadOptimizer(opt, module.named_parameters())
    state = {"params": dict(module.named_parameters()), "opt": opt,
             "step": 0}
    logger.info("auto_accelerate: %.1fM params on %s, %s%s",
                sum(p.numel() for p in module.parameters()) / 1e6, dev, spec,
                ", optimizer state offloaded" if offload_optimizer else "")
    return AccelerateResult(
        spec=spec, device=dev, state=state,
        train_step=make_train_step(module, loss, grad_accum=grad_accum),
        module=module,
    )


def _device_hbm(dev: torch.device) -> float:
    """The card's memory; an H100 80GB's on a CPU rank."""
    from dlrover_tpu_torch.accel.search import HBM_BYTES

    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return HBM_BYTES


def _devices_per_host(n: int) -> int:
    """Devices a host when the world spans hosts (``LOCAL_WORLD_SIZE``
    processes a host, one device each), else 0."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(n)) or n)
    hosts = -(-n // max(local, 1))
    return -(-n // hosts) if hosts > 1 else 0


def _auto(module, optimizer, sample_batch, loss, dev, grad_accum,
          offload_optimizer, profile, profile_steps, allow_tensor,
          search_top_k, registry=None) -> AccelerateResult:
    """The JAX package's ``"auto"`` branch: rank, then build the first
    candidate the port places (after the dry runs, with ``profile``)."""
    from dlrover_tpu_torch.accel import search

    n = _world_size()
    rows = sample_batch.shape[0]
    cfg = getattr(module, "cfg", None)
    params = sum(p.numel() for p in module.parameters())
    if cfg is not None and dataclasses.is_dataclass(cfg) \
            and hasattr(module, "logical_axes"):
        mprofile = search.ModelProfile.from_config(cfg, param_count=params)
        if allow_tensor is False:
            mprofile = dataclasses.replace(mprofile, num_heads=0)
    else:
        mprofile = search.ModelProfile.from_params(params)
        if allow_tensor:
            # A plain model the planner places can take tensor degrees:
            # a head count every degree divides, as JAX advertises.
            mprofile = dataclasses.replace(mprofile, num_heads=n)
    hbm = _device_hbm(dev)
    cache: Dict[Any, Any] = {}

    def abstract_for(sp):
        new = search.reconfigured_cfg(cfg, sp, rows)
        key = (sp.pipe, getattr(new, "attn_impl", None))
        if key not in cache:
            mod = module if new is cfg else search._meta_model(module, new)
            cache[key] = search.abstract_state(mod, optimizer)
        return cache[key]

    full = search.search_spec(
        mprofile, n, batch_size=rows, hbm=hbm, abstract_fn=abstract_for,
        top_k=1 << 30, devices_per_host=_devices_per_host(n))
    ranked = full[:max(1, search_top_k)]
    chosen, est = ranked[0]
    logger.info("auto_accelerate: %.1fM params on %s devices -> search "
                "chose %s", params / 1e6, n, chosen)
    if not est.fits(hbm) and not offload_optimizer:
        logger.warning(
            "auto_accelerate: best strategy %s needs %.1f GB/device "
            "(%.1f GB HBM); the optimizer state is %.0f%% of it — "
            "consider offload_optimizer=True and/or the 8-bit adam",
            chosen, est.total_bytes / 1e9, hbm / 1e9,
            100 * max(0.0, 1 - 8.0 * params / max(est.state_bytes, 1)))

    def placed(sp) -> bool:
        new = search.reconfigured_cfg(cfg, sp, rows)
        carries = {"stage": (getattr(new, "pipeline_stages", 0) or 0) > 1,
                   "expert": (getattr(new, "num_experts", 0) or 0) > 0}
        try:
            _check_candidate(sp, new, carries, optimizer, rows)
        except (NotImplementedError, ValueError, TypeError) as e:
            logger.info("strategy search: skipping %s, which the port does "
                        "not place: %s", sp, e)
            return False
        return True

    best = None
    if profile and len(ranked) > 1:
        best = _dry_runs([sp for sp, _ in ranked if placed(sp)], module,
                         optimizer, sample_batch, loss, dev, grad_accum,
                         profile_steps, registry, allow_tensor)
    if best is None:
        best = next((sp for sp, _ in full if placed(sp)), None)
    if best is None:
        raise NotImplementedError(
            f"the port places none of the {len(full)} candidates the "
            "strategy search ranked (each refusal is logged); see "
            "ROADMAP queue 1")
    res = _build(search.reconfigure_module(module, best, rows), optimizer,
                 sample_batch, loss, best, dev, grad_accum, offload_optimizer,
                 registry, allow_tensor)
    res.search_ranking = ranked
    return res


def _dry_runs(cands: List[ParallelSpec], module, optimizer, sample_batch,
              loss, dev, grad_accum, steps: int, registry=None,
              allow_tensor: Optional[bool] = None
              ) -> Optional[ParallelSpec]:
    """``profile=True``: each candidate built on its own copy of the
    pristine module with the optimizer bound afresh, one warm-up step and
    ``steps`` timed; each rank's time (inf when it failed) all-reduced
    with MAX, so every rank chooses the same fastest (None when all
    failed). Every rank builds the candidates in the same order, so their
    meshes make their groups alike. No dry-run step reaches the caller's
    module."""
    from dlrover_tpu_torch.accel import search

    rows = sample_batch.shape[0]
    best, best_t = None, math.inf
    for sp in cands:
        t = math.inf
        try:
            mod = search.reconfigure_module(copy.deepcopy(module), sp, rows)
            res = _build(mod, optimizer, sample_batch, loss, sp, dev,
                         grad_accum, False, registry, allow_tensor)
            batch = torch.as_tensor(res.local_batch(sample_batch)).to(dev)
            state = res.state
            _, m = res.train_step(state, batch)  # warm-up
            float(m["loss"])
            t0 = time.perf_counter()
            for _ in range(steps):
                _, m = res.train_step(state, batch)
            float(m["loss"])
            t = (time.perf_counter() - t0) / steps
            del res, state, mod
        except Exception as e:
            # The one place a failure is caught: a candidate that fails
            # is not chosen.
            logger.warning("dry-run %s failed: %s", sp, e)
        if _world_size() > 1:
            failed = not math.isfinite(t)
            agreed = torch.tensor([-1.0 if failed else t, float(failed)],
                                  dtype=torch.float64, device=dev)
            dist.all_reduce(agreed, op=dist.ReduceOp.MAX)
            t = math.inf if agreed[1].item() else agreed[0].item()
        logger.info("dry-run %s: %s ms/step", sp,
                    "failed" if math.isinf(t) else f"{t * 1e3:.1f}")
        if t < best_t:
            best, best_t = sp, t
    return best


# ------------------------------------------------------------ on a mesh


def _stack(module: nn.Module) -> nn.ModuleList:
    """The model's layer stack (GPT's ``blocks``, LLaMA's ``layers``)."""
    for name in ("blocks", "layers"):
        stack = getattr(module, name, None)
        if isinstance(stack, nn.ModuleList):
            return stack
    raise TypeError(f"{type(module).__name__} has no blocks or layers to "
                    "shard")


def _shard_param(holder: nn.Module, leaf: str, mesh, dim: int,
                 fused: int = 1):
    """``holder.<leaf>`` becomes a DTensor of this rank's shard along
    ``dim`` over ``mesh``'s tensor axis (``fused`` equal regions: GPT's
    qkv); returns its layout."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    tmesh = mesh["tensor"]
    full = getattr(holder, leaf)
    lay = sharding.Layout.of(mesh, {"tensor": dim}, fused)
    loc = sharding.local_from_full(full.detach(), lay)
    placements = [Shard(dim) if n == "tensor" else Replicate()
                  for n in tmesh.mesh_dim_names]
    dt = DTensor.from_local(loc, tmesh, placements, run_check=False,
                            shape=full.shape, stride=full.stride())
    setattr(holder, leaf, nn.Parameter(dt, requires_grad=full.requires_grad))
    return lay


def tensor_parallel(module: nn.Module, mesh, rules) -> Dict[str, Any]:
    """Shard ``module`` over ``mesh``'s tensor axis, in place: every
    ``Dense`` whose kernel's logical axes ``rules`` map to that axis
    becomes column-parallel (its output dim: ``qkv``, ``up``, the
    projections into heads and ``mlp``, LLaMA's vocab head) or
    row-parallel (its input dim: ``proj``, ``down``, ``o_proj``,
    ``down_proj``), its kernel (and a column-parallel bias) a DTensor of
    this rank's shard; the blocks compute on their local heads. An
    embedding whose ``vocab`` the rules map there (it divides) has its
    rows sharded and looked up vocab-parallel, and the model's
    ``vocab_mesh`` is set (GPT's tied head, LLaMA's untied one). Returns
    the layouts of the sharded parameters by name. A head count (LLaMA:
    also the kv heads) or ``mlp`` width the degree does not divide
    raises ``ValueError``."""
    from dlrover_tpu_torch.models.gpt import Block, Dense
    from dlrover_tpu_torch.models.llama import LlamaBlock

    size = axis_sizes(mesh)["tensor"]
    cfg = module.cfg
    counts = {"num_heads": cfg.num_heads, "mlp width": cfg.ff_dim}
    if hasattr(cfg, "kv_heads"):
        counts["num_kv_heads"] = cfg.kv_heads
    for what, n in counts.items():
        if n % size:
            raise ValueError(f"{type(module).__name__}'s {what} {n} does "
                             f"not divide by the tensor degree {size}")
    tmesh = mesh["tensor"]
    group = tmesh.get_group()
    layouts: Dict[str, Any] = {}
    for mname, m in module.named_modules():
        if isinstance(m, (Block, LlamaBlock)):
            m.tp_group = group
            m.heads = cfg.num_heads // size
            if isinstance(m, LlamaBlock):
                m.kv_heads = cfg.kv_heads // size
            continue
        if not isinstance(m, Dense):
            continue
        dims = sharding.mesh_dims(m.axes, rules)
        if "tensor" not in dims:
            continue
        dim = dims["tensor"]
        m.tp = ("column" if dim == len(m.axes) - 1 else "row", group)
        # GPT's fused qkv: this rank's heads of q, of k and of v.
        fused = 3 if mname.endswith(".qkv") else 1
        leaves = [("kernel", dim)]
        if m.bias is not None and m.tp[0] == "column":
            leaves.append(("bias", 0))
        for leaf, d in leaves:
            layouts[f"{mname}.{leaf}"] = _shard_param(m, leaf, mesh, d,
                                                      fused)
    axes = module.logical_axes()
    for mname, m in module.named_modules():
        name = f"{mname}.weight"
        if isinstance(m, nn.Embedding) and sharding.mesh_dims(
                axes[name], rules).get("tensor") == 0:
            layouts[name] = _shard_param(m, "weight", mesh, 0)
            module.vocab_mesh = tmesh
    return layouts


def _plain_axes(module: nn.Module, sample_batch, dev, registry, plan: bool):
    """A plain module's logical axes by parameter name: ``registry``'s,
    or with ``plan`` the planner's from one forward of the sample batch's
    first row, or the defaults. The planner labels the top-level head
    whose width is the largest ``nn.Embedding``'s rows ``vocab`` (JAX's
    ``build`` passes no vocab, so its head is ``mlp``): both map to the
    tensor axis under a plain module's rules, and the label tells
    ``plain_tensor_parallel`` which column layer gathers its logits,
    which GSPMD does for JAX."""
    from dlrover_tpu_torch.accel.registry import default_registry
    from dlrover_tpu_torch.accel.tp_planner import plan_tp

    reg = registry
    if reg is None and plan:
        logger.info("planning tensor-parallel placement automatically")
        vocab = max((m.num_embeddings for m in module.modules()
                     if isinstance(m, nn.Embedding)), default=0)
        reg = plan_tp(module, torch.as_tensor(sample_batch[:1]).to(dev),
                      vocab_size=vocab or None)
    logger.info("model carries no logical axes; annotating it with the "
                "sharding registry")
    return (reg or default_registry).axes_of(module)


def plain_tensor_parallel(module: nn.Module, mesh, rules, axes
                          ) -> Dict[str, Any]:
    """Shard a plain ``module`` over ``mesh``'s tensor axis by its logical
    ``axes`` (torch dim order), in place: an ``nn.Linear`` whose weight's
    out dim the rules map there becomes a column-parallel
    ``ParallelLinear`` (its bias sharded; all its logits gathered when
    the axis is ``vocab``), one whose in dim they map there a
    row-parallel one, an ``nn.Embedding`` whose rows they map there a
    ``VocabParallelEmbedding``; any other parameter the rules put there
    is stored as its shard and gathered whole before its module's
    forward (``gather_in_forward``). Returns the sharded parameters'
    layouts by name. A dim the rules put on the tensor axis that the
    degree does not divide raises ``ValueError`` (JAX's jit refuses
    that split), the vocab's too."""
    from dlrover_tpu_torch.models.tensor_parallel import (
        ParallelLinear,
        VocabParallelEmbedding,
        gather_in_forward,
    )

    tmesh = mesh["tensor"]
    size = axis_sizes(mesh)["tensor"]
    dims = {n: sharding.mesh_dims(a, rules)["tensor"]
            for n, a in axes.items()
            if "tensor" in sharding.mesh_dims(a, rules)}
    shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    for name, dim in dims.items():
        if shapes[name][dim] % size:
            raise ValueError(
                f"{name} of {shapes[name]}: dim {dim} ({axes[name][dim]}) "
                f"of {shapes[name][dim]} should be divisible by the tensor "
                f"degree {size}")
    layouts: Dict[str, Any] = {}
    for mname, m in list(module.named_modules()):
        weight = f"{mname}.weight"
        if weight not in dims or not isinstance(m, (nn.Linear,
                                                    nn.Embedding)):
            continue
        dim = dims[weight]
        if isinstance(m, nn.Embedding) and dim != 0:
            continue
        layouts[weight] = _shard_param(m, "weight", mesh, dim)
        if isinstance(m, nn.Embedding):
            new = VocabParallelEmbedding(m, tmesh)
        else:
            role = "col" if dim == 0 else "row"
            if role == "col" and m.bias is not None:
                layouts[f"{mname}.bias"] = _shard_param(m, "bias", mesh, 0)
            new = ParallelLinear(m, role, tmesh,
                                 gather=axes[weight][0] == "vocab")
        parent, _, leaf = mname.rpartition(".")
        setattr(module.get_submodule(parent), leaf, new)
    holders: Dict[str, Dict[str, int]] = {}
    for name, dim in dims.items():
        if name in layouts or (name.endswith(".bias") and name[:-len(
                ".bias")] + ".weight" in layouts):
            continue
        mname, _, leaf = name.rpartition(".")
        holders.setdefault(mname, {})[leaf] = dim
    for mname, leaves in holders.items():
        holder = module.get_submodule(mname)
        for leaf, dim in leaves.items():
            name = f"{mname}.{leaf}" if mname else leaf
            layouts[name] = _shard_param(holder, leaf, mesh, dim)
        gather_in_forward(holder, leaves, tmesh)
    return layouts


def _shard_leaves(module: nn.Module, mesh, axis: str) -> Dict[str, Any]:
    """Every parameter whose logical axes name ``axis`` (JAX's rules map
    ``seq`` and ``expert`` to the mesh axes of those names) becomes a
    DTensor of this rank's chunk along that dim (``Shard``, as
    ``torch.chunk`` splits); returns their layouts by name."""
    from torch.distributed.tensor import DTensor, Shard

    size = axis_sizes(mesh)[axis]
    sub = mesh[axis]
    layouts: Dict[str, Any] = {}
    for name, axes in module.logical_axes().items():
        if axis not in axes:
            continue
        dim = axes.index(axis)
        full = module.get_parameter(name)
        if full.shape[dim] % size:
            raise ValueError(f"{name}'s dim {dim} of {full.shape[dim]} does "
                             f"not divide by the {axis} degree {size}")
        lay = sharding.Layout.of(mesh, {axis: dim})
        loc = sharding.local_from_full(full.detach(), lay)
        dt = DTensor.from_local(loc, sub, [Shard(dim)], run_check=False,
                                shape=full.shape, stride=full.stride())
        parent, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(parent), leaf,
                nn.Parameter(dt, requires_grad=full.requires_grad))
        layouts[name] = lay
    return layouts


def expert_parallel(module: nn.Module, mesh) -> Dict[str, Any]:
    """Shard every MoE layer's expert stacks over ``mesh``'s expert axis
    (dim 0, this rank's ``E/K`` experts; the router along its expert
    columns), in place; returns their layouts by name. An expert count
    the degree does not divide raises ``ValueError``, as does a degree
    above 1 with no expert parameter (JAX's ``_check_spec_axes_used``:
    those devices would be wasted)."""
    size = axis_sizes(mesh)["expert"]
    experts = getattr(module.cfg, "num_experts", 0)
    if size > 1 and not experts:
        raise ValueError(
            f"an expert degree of {size}, but no parameter of "
            f"{type(module).__name__} carries the 'expert' logical axis; "
            "configure num_experts or drop the degree")
    if experts % size:
        raise ValueError(f"num_experts {experts} does not divide by the "
                         f"expert degree {size}")
    return _shard_leaves(module, mesh, "expert")


def sequence_parallel(module: nn.Module, mesh) -> Dict[str, Any]:
    """Place ``module`` on ``mesh``'s seq axis, in place: it keeps its
    shard of each row's sequence, attends over the axis's group (ring or
    Ulysses; a degree above 1 with any other attention raises
    ``NotImplementedError``: JAX's GSPMD would gather the sequence),
    and GPT's position rows are sharded over it. Returns the sharded
    parameters' layouts by name."""
    size = axis_sizes(mesh)["seq"]
    attn = module.cfg.attn_impl
    if size > 1 and attn not in ("ring", "ulysses"):
        raise NotImplementedError(
            f"a seq degree of {size} with attn_impl={attn!r} (JAX's GSPMD "
            "gathers the sequence for it) comes with " + _ITEM6
            + "; use attn_impl='ring' or 'ulysses'")
    layouts = _shard_leaves(module, mesh, "seq")
    module.seq_mesh = mesh["seq"]
    for block in _stack(module):
        block.seq_group = mesh.get_group("seq")
    return layouts


def pipeline_parallel(module: nn.Module, mesh) -> Dict[str, Any]:
    """Place a pipelined ``module`` on ``mesh``'s pipe axis, in place: this
    rank keeps its block of stages (``_Schedule.place``) and the ends of
    the model its first or last stage reads (``keep_ends``). Returns the
    layouts of what it keeps: a stage's parameters placed on this pipe
    coordinate (their JAX leaf's stage dim sharded over the axis), the
    embedding, final norm and head on theirs, and GPT's tied ``wte``,
    which the first and last ranks both hold, replicated (the first
    persists it). A model without stages, or a stage count the degree
    does not divide, raises ``ValueError``."""
    from dlrover_tpu_torch.accel.pipeline import PipeRanks

    size = axis_sizes(mesh)["pipe"]
    _check_spec_axes_used(ParallelSpec(pipe=size), _carries(module))
    pipe = module.pipeline
    if pipe.num_stages % size:
        raise ValueError(f"pipeline_stages {pipe.num_stages} does not "
                         f"divide by the pipe degree {size}")
    axis = mesh.mesh_dim_names.index("pipe")
    ranks = mesh.mesh

    def line(coord, i):
        c = list(coord)
        c[axis] = i
        return int(ranks[tuple(c)])

    coord = list(mesh.get_coordinate())
    ends = None
    if getattr(module, "TIED", ()):
        # Every rank makes every line's group of its two ends.
        others = [range(n) if i != axis else range(1)
                  for i, n in enumerate(ranks.shape)]
        for c in itertools.product(*others):
            pair = [line(c, 0), line(c, size - 1)]
            group = dist.new_group(pair)
            if dist.get_rank() in pair:
                ends = group
    r = coord[axis]
    pipe.place(PipeRanks(r, tuple(line(coord, i) for i in range(size)),
                         ends))
    module.keep_ends(pipe.first, pipe.last)
    free = (None,) * ranks.ndim
    stage = sharding.Layout(mesh, free, placed=(axis,),
                            stages=pipe.num_stages)
    placed = sharding.Layout(mesh, free, placed=(axis,))
    replicated = sharding.Layout.replicated(mesh)
    return {name: (stage if name.startswith("pipeline.")
                   else replicated if name in module.TIED else placed)
            for name, _ in module.named_parameters()}


def _fsdp_units(module: nn.Module) -> List[nn.Module]:
    """The modules FSDP2 shards as units before the root: an annotated
    model's blocks; a plain module's, the items of its outermost
    ``nn.ModuleList``s that hold parameters, or without one its direct
    children that hold parameters and modules of their own."""
    if has_annotations(module):
        return list(_stack(module))
    items: List[nn.Module] = []

    def walk(m):
        for child in m.children():
            if isinstance(child, nn.ModuleList):
                items.extend(child)
            else:
                walk(child)

    walk(module)
    if not items:
        items = [c for c in module.children()
                 if next(c.children(), None) is not None]
    return [m for m in items if next(m.parameters(), None) is not None]


def fully_shard_model(module: nn.Module, mesh, rules, axes,
                      layouts=None) -> Dict[str, Any]:
    """FSDP2 over ``mesh``'s fsdp axis: ``fully_shard`` on each unit
    (``_fsdp_units``), then on the root. Every parameter is sharded
    along the dim ``rules`` map its logical ``axes`` to the fsdp axis
    (its ``embed``; FSDP2's ``shard_placement_fn``), dim 0 without one;
    a tensor-parallel DTensor is sharded over the fsdp axis of the same
    mesh (FSDP2's 2-D form). Returns the layouts by name: ``layouts``'
    (the tensor axis's) with the fsdp axis added."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    layouts = layouts or {}
    named = dict(module.named_parameters())
    dims = {n: sharding.mesh_dims(axes[n], rules).get("fsdp", 0)
            for n in named}
    by_param = {id(p): Shard(dims[n]) for n, p in named.items()}
    kw = {"mesh": mesh["fsdp"],
          "shard_placement_fn": lambda p: by_param[id(p)]}
    for unit in _fsdp_units(module):
        fully_shard(unit, **kw)
    fully_shard(module, **kw)
    axis = mesh.mesh_dim_names.index("fsdp")
    out = {}
    for name in named:
        lay = layouts.get(name) or sharding.Layout.replicated(mesh)
        shard = list(lay.shard)
        shard[axis] = dims[name]
        out[name] = dataclasses.replace(lay, shard=tuple(shard))
    return out


class MeshOptimizer:
    """An ``update_and_apply`` optimizer (``adam8bit``,
    ``bf16_master_weights``) over sharded parameters, with its state
    whole and replicated, as the JAX package keeps the 8-bit moments
    under FSDP and TP: the inner optimizer (``inner``) is bound to the
    whole tensors (``full``); a step gathers each sharded leaf's
    gradient and parameter into them, updates every leaf at once and
    writes this rank's shard back. A parameter no axis shards is its
    own whole tensor, so on a mesh of one rank nothing is copied."""

    def __init__(self, optimizer, named_parameters, layouts):
        self.params = dict(named_parameters)
        self.layouts = layouts
        self._names = {id(p): n for n, p in self.params.items()}
        self._sharded = {n for n, p in self.params.items()
                         if layouts.get(n) is not None
                         and layouts[n].sharded_axes()}
        with torch.no_grad():
            self.full = {
                n: (sharding.gather_full(p, layouts.get(n), p.shape)
                    if n in self._sharded else sharding.local(p))
                for n, p in self.params.items()}
        self._grads: Dict[str, torch.Tensor] = {}
        self.inner = bind(optimizer, self.full.items())

    @property
    def state(self):
        return self.inner.state

    def update_and_apply(self, grads, params):
        names = [self._names[id(p)] for p in params]
        whole = []
        with torch.no_grad():
            for n, g in zip(names, grads):
                if n not in self._sharded:
                    if sharding.local(self.params[n]).data_ptr() != \
                            self.full[n].data_ptr():
                        raise RuntimeError(
                            f"parameter {n}'s storage moved since the "
                            "optimizer was bound")
                    whole.append(sharding.local(g))
                    continue
                lay, p = self.layouts[n], self.params[n]
                if n not in self._grads:
                    self._grads[n] = torch.empty_like(self.full[n])
                whole.append(sharding.gather_full(g, lay, p.shape,
                                                  out=self._grads[n]))
                # A restore may have rewritten the shard since.
                sharding.gather_full(p, lay, p.shape, out=self.full[n])
            self.inner.update_and_apply(whole, [self.full[n] for n in names])
            for n in names:
                if n in self._sharded:
                    sharding.scatter_local(self.full[n], self.params[n],
                                           self.layouts[n])


def _bind_on_mesh(optimizer, module: nn.Module, layouts, mesh=None,
                  zero_rules=None, axes=None):
    """Under ZeRO-1 (``zero_rules``: the spec's rules; ``axes``: a plain
    module's logical axes) the optimizer is a ``ZeroOptimizer`` over
    ``mesh``'s data axis, unless no leaf can be sliced; otherwise a
    ``takes_named_parameters`` optimizer becomes a ``MeshOptimizer``
    (on pipe ranks it gathers nothing: the parameters it binds are the
    rank's stages and ends, laid out as such), and a torch optimizer
    factory gets a param group for the plain
    parameters and one for the DTensors of each mesh (a foreach step
    takes one kind, on one mesh, at a time)."""
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.models.convert import materialize_adam_state

    named = list(module.named_parameters())
    if zero_rules is not None and not isinstance(
            optimizer, torch.optim.Optimizer) and not hasattr(
            optimizer, "update_and_apply"):
        from dlrover_tpu_torch.accel.zero import zero_optimizer

        opt = zero_optimizer(optimizer, module, layouts, mesh, zero_rules,
                             axes)
        if opt is not None:
            return opt
    if getattr(optimizer, "takes_named_parameters", False):
        return MeshOptimizer(optimizer, named, layouts)
    if isinstance(optimizer, torch.optim.Optimizer) or hasattr(
            optimizer, "update_and_apply"):
        raise TypeError("on a mesh, pass the optimizer unbound: its "
                        "parameters are the sharded ones")
    groups: Dict[Any, list] = {}
    for _, p in named:
        mesh_of = p.device_mesh if isinstance(p, DTensor) else None
        key = None if mesh_of is None else (
            mesh_of.mesh_dim_names, tuple(mesh_of.mesh.reshape(-1).tolist()))
        groups.setdefault(key, []).append(p)
    if len(groups) == 1:
        return bind(optimizer, named)
    opt = optimizer([{"params": ps} for ps in groups.values()])
    materialize_adam_state(opt)
    return opt


def accelerate_on_mesh(
    module: nn.Module,
    optimizer,
    sample_batch,
    loss: Callable,
    mesh,
    device: DeviceLike = None,
    grad_accum: int = 1,
    offload_optimizer: bool = False,
    zero: bool = False,
    registry=None,
    allow_tensor: Optional[bool] = None,
) -> AccelerateResult:
    """``auto_accelerate``'s multi-device branch on ``mesh`` (a
    ``DeviceMesh`` whose axes are among ``data``, ``fsdp``, ``pipe``,
    ``seq``, ``expert`` and ``tensor``, of any sizes, 1 included: an
    axis of size 1 takes its branch, its rules those of a degree above
    1; ``mesh.create_mesh``). Every process passes the same module,
    initialized alike, and the same global ``sample_batch``. ``zero``:
    ZeRO-1 over the data axis (which the mesh must have).
    ``offload_optimizer``: the big leaves of the state this rank holds
    lie in host memory between steps. A model without
    ``logical_axes()`` is placed by ``registry``, or the planner's (a
    tensor axis, or ``allow_tensor=True``), or the defaults."""
    sizes = axis_sizes(mesh)
    other = [a for a in sizes if a not in MESH_AXES]
    if other:
        raise ValueError(f"unknown mesh axes {other}; the axes are "
                         f"{MESH_AXES}")
    _check_mesh(sizes, _carries(module))
    if zero:
        if "data" not in sizes:
            raise ValueError(f"zero=True needs a data axis; the mesh has "
                             f"{list(sizes)}")
        _check_spec(ParallelSpec(zero=True, **{
            a: n for a, n in sizes.items() if n > 1}), _carries(module))
    pipe = getattr(module, "pipeline", None)
    moe = [m for m in module.modules() if isinstance(m, MoEMLP)]
    spec = ParallelSpec(zero=zero,
                        **{a: sizes.get(a, 1) for a in MESH_AXES})
    dev = resolve_device(device)
    rows = sample_batch.shape[0]
    shards = sizes.get("data", 1) * sizes.get("fsdp", 1)
    if rows % shards:
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"over {shards} data/fsdp ranks")
    if (rows // shards) % grad_accum:
        raise ValueError(f"a rank's batch of {rows // shards} rows is not "
                         f"divisible by grad_accum {grad_accum}")
    # A pipelined model's microbatches (of each accumulation step): each
    # data rank takes its slice of every one.
    parts = 1 if pipe is None else grad_accum * pipe.num_microbatches
    if rows % (parts * shards):
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"into {parts} microbatches over {shards} "
                         "data/fsdp ranks")
    if sample_batch.shape[1] % sizes.get("seq", 1):
        raise ValueError(f"a sequence of {sample_batch.shape[1]} tokens "
                         f"does not split over {sizes['seq']} seq ranks")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shard = coord.get("data", 0) * sizes.get("fsdp", 1) + coord.get("fsdp", 0)
    width = rows // parts // shards
    module = module.to(dev)
    plain = not has_annotations(module)
    axes = (_plain_axes(module, sample_batch, dev, registry,
                        allow_tensor or "tensor" in sizes) if plain
            else module.logical_axes())
    rules = spec.rules(vocab_size=getattr(getattr(module, "cfg", None),
                                          "vocab_size", 0) or 0,
                       present=tuple(sizes))
    layouts: Dict[str, Any] = {}
    if sizes.get("pipe", 1) > 1:
        layouts.update(pipeline_parallel(module, mesh))
    if "tensor" in sizes:
        layouts.update(plain_tensor_parallel(module, mesh, rules, axes)
                       if plain else tensor_parallel(module, mesh, rules))
    if "fsdp" in sizes:
        layouts = fully_shard_model(module, mesh, rules, axes, layouts)
    if "expert" in sizes:
        layouts.update(expert_parallel(module, mesh))
    if "seq" in sizes:
        layouts.update(sequence_parallel(module, mesh))
    for m in moe:
        m.expert, m.data, m.seq = (Axis.of(mesh, a) if a in sizes else None
                                   for a in ("expert", "data", "seq"))
    replicated = sharding.Layout.replicated(mesh)
    for name, p in module.named_parameters():
        layouts.setdefault(name, replicated)
        sharding.set_layout(p, layouts[name])
    opt = _bind_on_mesh(optimizer, module, layouts, mesh,
                        rules if zero else None, axes if plain else None)
    if offload_optimizer:
        opt = OffloadOptimizer(opt, module.named_parameters())
    state = {"params": dict(module.named_parameters()), "opt": opt,
             "step": 0}
    logger.info("auto_accelerate: %.1fM params on mesh %s (%s), rows "
                "[%s, %s) of each of %s parts of %s%s",
                sum(p.numel() for p in module.parameters()) / 1e6, sizes, dev,
                shard * width, (shard + 1) * width, parts, rows,
                ", optimizer state offloaded" if offload_optimizer else "")
    return AccelerateResult(
        spec=spec, device=dev, state=state,
        train_step=make_train_step(module, loss, grad_accum=grad_accum,
                                   mesh=mesh),
        module=module, mesh=mesh,
        batch_rows=((shard * width, (shard + 1) * width), rows), parts=parts,
    )

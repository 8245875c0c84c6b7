"""Strategy search of the port — counterpart of ``dlrover_tpu/accel/search.py``.

The same engine as the JAX package's: a ``ParallelSpec`` is six mesh
degrees (and the ZeRO flag), so ``enumerate_specs`` lists every
factorization of the device count the model can run, ``estimate``
scores each with an analytic memory and roofline model, and
``search_spec`` ranks the ones that fit; ``auto_accelerate(spec="auto",
profile=True)`` then times the top few on the real mesh.

- **Memory** (feasibility): the per-device train-state bytes are exact.
  JAX reads them from ``jax.eval_shape`` of the boxed state; the port
  builds the candidate model on the ``meta`` device (no bytes are
  allocated), binds the optimizer to it (its own rule makes its state's
  shapes; nothing is stepped), lays the state out as the JAX train
  state's leaves (``models/convert.train_state_leaves``) with each
  leaf's logical names (``accel/zero.param_names``), and divides each
  dim by the degrees its names map to under ``spec.rules()``; a ZeRO
  spec first relabels the optimizer state as ``accel/zero.py`` slices
  it. Activations and the fp32 loss-path logits are analytic.
- **Time** (ranking): the model FLOPs at a derated peak, the pipeline
  bubble ``(M+P-1)/M`` and its weight-traffic floor, and a bandwidth
  and latency term a collective (all-gather / reduce-scatter for FSDP,
  the gradient all-reduce for data, ZeRO's exposed gather, activation
  all-reduces for tensor, the K/V ring for seq, all-to-all for expert,
  stage transfers for pipe).

Every constant is a keyword argument; the defaults are the H100's (see
each one's comment). The per-axis collective algorithm (``collectives``)
and a measured link profile come with the comms governor (ROADMAP queue
1, item 5), the rescale functions (``spec_from_dict``, ``spec_diff``,
``spec_move_distance``, ``search_reshape_spec``) with the elastic
trainer (item 4).
"""

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from dlrover_tpu_torch.accel.mesh import AXIS_ORDER
from dlrover_tpu_torch.accel.zero import (
    AbstractLeaf,
    apply_zero,
    param_names,
)
from dlrover_tpu_torch.common.log import logger

# Share of the peak the step reaches: CALIBRATED on one H100 80GB HBM3
# at 700 W from chip_smoke.py's LLaMA 1.15B windows at 4 x 2048, the
# steps the card sets (busy 84-93%): MFU 32.32% without remat (205.52 ms
# a step) and 25.51% under "dots" (260.39 ms), medians of two rounds;
# their geometric mean. estimate().step_s is then within +-30% of both
# (pinned by tests/test_torch_search.py::TestCalibratedAgainstChip).
# Remat's recompute is inside the derate: flops_per_token counts the
# algorithmic FLOPs only.
MFU_DERATE = 0.2871
# H100 SXM dense bf16 tensor-core peak, FLOP/s (NVIDIA's spec sheet).
PEAK_FLOPS = 989e12
# NVLink 4 between the H100s of one host: 900 GB/s a card, 450 GB/s each
# way (NVIDIA's spec sheet), bytes/s.
ICI_BW = 450e9
# Between hosts: one 400 Gb/s InfiniBand NDR port a card (DGX H100 spec
# sheet), bytes/s.
DCN_BW = 50e9
# H100 SXM HBM3 bandwidth, bytes/s (NVIDIA's spec sheet): the pipeline's
# weight-traffic floor.
HBM_BW = 3.35e12
# The card's memory when the search runs on a CPU rank: an H100 80GB's
# (on the card, torch.cuda.get_device_properties reads it).
HBM_BYTES = 80e9
# Latency of one collective within a host and across hosts, seconds. Not
# measured (one card cannot): the order of NCCL's small-message latency
# over NVLink and over InfiniBand. The bandwidth terms dominate at real
# scale; this one makes a collective every layer lose to one gradient
# all-reduce on models too small to amortize it.
COLL_LAT = 10e-6
DCN_LAT = 30e-6


def _axis_links(spec, devices_per_host: int) -> dict:
    """Which mesh axes cross hosts: an axis is host-local when the block
    its collectives span (its size times every axis inner to it, in
    ``AXIS_ORDER``) fits in one host; with ``devices_per_host`` 0 (one
    host) none does."""
    sizes = _axis_sizes(spec)
    crossing = {}
    for i, axis in enumerate(AXIS_ORDER):
        inner = 1
        for later in AXIS_ORDER[i + 1:]:
            inner *= sizes.get(later, 1)
        span = inner * sizes.get(axis, 1)
        crossing[axis] = bool(devices_per_host and span > devices_per_host)
    return crossing


def _dtype_bytes(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    import numpy as np

    return int(np.dtype(dtype).itemsize)


@dataclass(frozen=True)
class ModelProfile:
    """What the search needs to know about a model: from its config
    dataclass (``from_config``, the JAX package's fields), or the
    data/fsdp-only fallback (``from_params``)."""

    param_count: int
    num_layers: int = 0
    d_model: int = 0
    ff_dim: int = 0
    seq_len: int = 0
    vocab_size: int = 0
    num_heads: int = 0
    num_experts: int = 0
    moe_top_k: int = 2
    remat: bool = False
    remat_policy: str = "nothing"
    supports_ring: bool = False
    supports_pipeline: bool = False
    mlp_int8: bool = False
    vocab_params: int = 0
    expert_ffn_params: int = 0
    dtype_bytes: int = 2
    param_dtype_bytes: int = 4
    # Analytic train-state bytes a parameter: param + grad at the param
    # dtype, fp32 Adam moments (8), and an fp32 master (4) when the
    # params are not fp32.
    state_bytes_per_param: float = 16.0
    flops_per_token: float = 0.0

    @staticmethod
    def from_config(cfg, param_count: Optional[int] = None) -> "ModelProfile":
        """From a ``GPTConfig`` / ``LlamaConfig``-shaped dataclass."""
        count = int(cfg.param_count()) if param_count is None else param_count
        fields = {f.name for f in dataclasses.fields(cfg)}
        # Expert-sharded FFN params: LLaMA's swiglu has three bias-free
        # projections, GPT's MLP two biased ones; the router stays out.
        n_exp = getattr(cfg, "num_experts", 0)
        d = getattr(cfg, "d_model", 0)
        f_dim = getattr(cfg, "ff_dim", 0)
        per_expert = (3 * d * f_dim if "num_kv_heads" in fields
                      else 2 * d * f_dim + f_dim + d)
        expert_ffn = (getattr(cfg, "num_layers", 0) * n_exp * per_expert
                      if n_exp > 1 else 0)
        pd = 4
        pdt = getattr(cfg, "param_dtype", None)
        if pdt is not None:
            try:
                pd = _dtype_bytes(pdt)
            except TypeError:
                pd = 4
        sbpp = 2.0 * pd + 8.0 + (0.0 if pd == 4 else 4.0)
        return ModelProfile(
            param_count=count,
            num_layers=getattr(cfg, "num_layers", 0),
            d_model=d,
            ff_dim=f_dim,
            seq_len=getattr(cfg, "max_seq_len", 0),
            vocab_size=getattr(cfg, "vocab_size", 0),
            num_heads=getattr(cfg, "num_heads", 0),
            num_experts=n_exp,
            moe_top_k=getattr(cfg, "moe_top_k", 2),
            remat=getattr(cfg, "remat", False),
            remat_policy=getattr(cfg, "remat_policy", "nothing"),
            supports_ring="attn_impl" in fields,
            supports_pipeline="pipeline_stages" in fields,
            mlp_int8=getattr(cfg, "mlp_precision", "bf16") == "int8",
            vocab_params=(int(cfg.vocab_param_count())
                          if hasattr(cfg, "vocab_param_count")
                          else getattr(cfg, "vocab_size", 0) * d),
            expert_ffn_params=expert_ffn,
            param_dtype_bytes=pd,
            state_bytes_per_param=sbpp,
            flops_per_token=(float(cfg.flops_per_token())
                             if hasattr(cfg, "flops_per_token")
                             else 6.0 * count),
        )

    @staticmethod
    def from_params(param_count: int) -> "ModelProfile":
        return ModelProfile(param_count=param_count,
                            flops_per_token=6.0 * param_count)


@dataclass(frozen=True)
class CostEstimate:
    """Per-device memory and estimated step time of one candidate."""

    state_bytes: float       # params + optimizer state + step
    grad_bytes: float        # gradients (at the param dtype)
    act_bytes: float         # saved activations + loss-path logits
    compute_s: float
    comm_overlap_s: float    # FSDP gathers / the data gradient sum
    comm_critical_s: float   # tensor, ring, expert, stage transfers
    bubble: float            # pipeline multiplier on compute, >= 1
    hbm_s: float = 0.0       # the pipeline's weight-traffic floor

    @property
    def total_bytes(self) -> float:
        return self.state_bytes + self.grad_bytes + self.act_bytes

    @property
    def comm_s(self) -> float:
        return self.comm_overlap_s + self.comm_critical_s

    @property
    def step_s(self) -> float:
        return (max(self.compute_s * self.bubble, self.hbm_s)
                + 0.15 * self.comm_overlap_s
                + 0.5 * self.comm_critical_s)

    def fits(self, hbm: float, headroom: float = 0.9) -> bool:
        return self.total_bytes <= hbm * headroom


def _axis_sizes(spec) -> dict:
    return {"data": spec.data, "fsdp": spec.fsdp, "tensor": spec.tensor,
            "seq": spec.seq, "expert": spec.expert, "pipe": spec.pipe}


# ------------------------------------------------------ the exact state


def _meta_model(module, cfg):
    """A model of ``module``'s class and ``cfg`` on the meta device."""
    return type(module)(cfg, device="meta", generator=torch.Generator())


def abstract_state(module, optimizer) -> Optional[List[AbstractLeaf]]:
    """The JAX train state of ``module`` (any device; its parameters'
    shapes and dtypes are read, nothing copied) under the unbound
    ``optimizer``, as ``AbstractLeaf``s in JAX's order: the optimizer
    bound to meta tensors of the parameters' shapes, its state laid out
    by ``train_state_leaves``; a model without logical axes (a plain
    module) has no names on any leaf, as JAX's unannotated tree has
    none. None for an optimizer without the JAX state's layout (AGD),
    or one already bound."""
    from dlrover_tpu_torch.models.convert import (
        param_leaves,
        train_state_leaves,
    )
    from dlrover_tpu_torch.optim.base import bind

    if isinstance(optimizer, torch.optim.Optimizer) or hasattr(
            optimizer, "update_and_apply"):
        return None
    meta = {n: torch.empty(p.shape, dtype=p.dtype, device="meta")
            for n, p in module.named_parameters()}
    groups = param_leaves(meta)
    try:
        opt = bind(optimizer, meta.items())
        leaves = train_state_leaves({"params": meta, "opt": opt, "step": 0},
                                    groups=groups)
    except Exception as e:
        # No exact layout (AGD has no JAX state layout in the port): the
        # analytic estimate, as JAX's without an abstract tree.
        logger.info("strategy search: analytic state bytes (%s)", e)
        return None
    names = (param_names(module, groups) if hasattr(module, "logical_axes")
             else {})
    return [AbstractLeaf(leaf.path, tuple(leaf.shape), leaf.dtype.itemsize,
                         names.get(leaf.param_path)) for leaf in leaves]


def state_bytes_per_device(abstract: List[AbstractLeaf], spec) -> int:
    """Exact per-device train-state bytes of a candidate: each boxed
    leaf's dims ceil-divided by the sizes of the mesh axes its names map
    to under ``spec.rules()`` (a ZeRO spec's optimizer state relabelled
    first, as ``build`` slices it)."""
    rules_seq = spec.rules()
    if getattr(spec, "zero", False) and getattr(spec, "data", 1) > 1:
        abstract = apply_zero(abstract, spec, rules_seq, warn=False)
    rules = dict(rules_seq)
    sizes = _axis_sizes(spec)
    total = 0
    for leaf in abstract:
        n = 1
        for i, dim in enumerate(leaf.shape):
            div = 1
            if leaf.names is not None and i < len(leaf.names) \
                    and leaf.names[i]:
                mesh_axes = rules.get(leaf.names[i])
                if mesh_axes is not None:
                    if isinstance(mesh_axes, str):
                        mesh_axes = (mesh_axes,)
                    for ax in mesh_axes:
                        div *= sizes.get(ax, 1)
            n *= math.ceil(dim / div)
        total += n * leaf.itemsize
    return total


# ------------------------------------------------------ the estimate


def _act_floats_per_token_layer(p: ModelProfile) -> float:
    """Saved-activation floats a token a layer under the remat policy
    (flash attention: no [S, S] term)."""
    d, f = max(p.d_model, 1), max(p.ff_dim, 4 * max(p.d_model, 1))
    if p.remat and p.remat_policy == "nothing":
        return 2.0 * d
    if p.remat:
        return 5.0 * d + f
    return 10.0 * d + 2.0 * f


def estimate(
    profile: ModelProfile,
    spec,
    batch_size: int,
    hbm: float,
    abstract_state: Optional[List[AbstractLeaf]] = None,
    peak_flops: float = PEAK_FLOPS,
    ici_bw: float = ICI_BW,
    microbatches: int = 0,
    devices_per_host: int = 0,
    dcn_bw: float = DCN_BW,
    hbm_bw: float = HBM_BW,
    mfu_derate: float = MFU_DERATE,
    coll_lat: float = COLL_LAT,
    dcn_lat: float = DCN_LAT,
) -> CostEstimate:
    """Analytic memory and roofline cost of one candidate spec (the JAX
    package's model, term by term). ``devices_per_host > 0`` prices a
    mesh axis whose collective block spans hosts at ``dcn_bw`` and
    ``dcn_lat``."""
    if getattr(spec, "collectives", ()):
        raise NotImplementedError(
            "pricing a spec's collectives comes with the comms governor "
            "(ROADMAP queue 1, item 5)")
    p = profile
    dp = spec.data * spec.fsdp
    tokens_dev = batch_size * max(p.seq_len, 1) / (dp * spec.seq)
    dtype_b = p.dtype_bytes

    # --- memory ---
    zero_shard = (spec.data if getattr(spec, "zero", False)
                  and spec.data > 1 else 1)
    param_shard = spec.fsdp * spec.tensor * spec.expert * spec.pipe
    if abstract_state is not None:
        state_b = float(state_bytes_per_device(abstract_state, spec))
        grad_b = float(p.param_dtype_bytes) * p.param_count / param_shard
    else:
        # Only the widened optimizer share divides by the ZeRO degree.
        opt_pp = max(p.state_bytes_per_param - 2.0 * p.param_dtype_bytes,
                     0.0)
        state_b = ((p.state_bytes_per_param - opt_pp) * p.param_count
                   / param_shard
                   + opt_pp * p.param_count / (param_shard * zero_shard))
        grad_b = 0.0
    layers_dev = max(p.num_layers, 1) / spec.pipe
    act_b = layers_dev * _act_floats_per_token_layer(p) * tokens_dev * dtype_b
    if p.vocab_size:
        act_b += (tokens_dev * p.vocab_size / (spec.tensor * spec.pipe)
                  * (4.0 + dtype_b))

    # --- compute ---
    flops_step = p.flops_per_token * batch_size * max(p.seq_len, 1)
    compute_s = flops_step / spec.total / (peak_flops * mfu_derate)
    if spec.tensor > 1 and p.ff_dim:
        # Narrow sharded matmuls under-fill the tensor cores.
        eff = min(1.0, max(0.1, (p.ff_dim / spec.tensor) / 2048.0))
        compute_s /= eff
    if p.mlp_int8:
        compute_s /= 0.93
    m = microbatches or _pipe_microbatches(spec.pipe, batch_size, dp)
    bubble = (m + spec.pipe - 1) / m if spec.pipe > 1 else 1.0

    # --- communication ---
    crossing = _axis_links(spec, devices_per_host)

    def bw(axis):
        return dcn_bw if crossing.get(axis) else ici_bw

    def lat(axis):
        return dcn_lat if crossing.get(axis) else coll_lat

    comm_ov_s = 0.0
    comm_cp_s = 0.0
    pbytes_tp = 2.0 * p.param_count / (spec.tensor * spec.expert * spec.pipe)
    if spec.fsdp > 1:
        vol = 3.0 * pbytes_tp * (spec.fsdp - 1) / spec.fsdp
        comm_ov_s += vol / bw("fsdp")
        comm_cp_s += 3.0 * layers_dev * lat("fsdp")
    if spec.data > 1:
        vol = 2.0 * (pbytes_tp / spec.fsdp) * (spec.data - 1) / spec.data
        comm_ov_s += vol / bw("data")
        comm_cp_s += lat("data")
    if zero_shard > 1:
        # The gather of the updated params sits at the step's end: a
        # quarter of it exposed, and one more collective.
        ag = ((pbytes_tp / spec.fsdp) * (spec.data - 1) / spec.data
              / bw("data"))
        comm_cp_s += 0.25 * ag + lat("data")
    if spec.tensor > 1:
        comm_cp_s += (8.0 * layers_dev * tokens_dev * p.d_model * dtype_b
                      * (spec.tensor - 1) / spec.tensor / bw("tensor"))
        comm_cp_s += 4.0 * layers_dev * lat("tensor")
    if spec.seq > 1:
        comm_cp_s += (3.0 * 2.0 * layers_dev * tokens_dev * p.d_model
                      * dtype_b * (spec.seq - 1) / bw("seq"))
        comm_cp_s += 3.0 * layers_dev * spec.seq * lat("seq")
    if spec.expert > 1:
        comm_cp_s += (4.0 * layers_dev * tokens_dev * p.d_model * dtype_b
                      * p.moe_top_k * (spec.expert - 1) / spec.expert
                      / bw("expert"))
        comm_cp_s += 4.0 * layers_dev * lat("expert")
    hbm_s = 0.0
    if spec.pipe > 1:
        comm_cp_s += 2.0 * tokens_dev * p.d_model * dtype_b / bw("pipe")
        comm_cp_s += 2.0 * (m + spec.pipe - 1) * lat("pipe")
        # Each tick re-reads the stage's resident weights (about three
        # passes with the backward): the layer stack's params, the
        # expert FFNs divided by the expert degree too.
        layer_params = max(p.param_count - p.vocab_params, 0.0)
        expert_ffn = min(float(p.expert_ffn_params), layer_params)
        dense_params = layer_params - expert_ffn
        resident_b = dtype_b * (
            dense_params / (spec.pipe * spec.tensor)
            + expert_ffn / (spec.pipe * spec.tensor * spec.expert))
        hbm_s = 3.0 * (m + spec.pipe - 1) * resident_b / hbm_bw

    return CostEstimate(
        state_bytes=state_b, grad_bytes=grad_b, act_bytes=act_b,
        compute_s=compute_s, comm_overlap_s=comm_ov_s,
        comm_critical_s=comm_cp_s, bubble=bubble, hbm_s=hbm_s,
    )


def _pipe_microbatches(pipe: int, batch_size: int, dp: int) -> int:
    """Microbatches the runtime uses for a pipe degree: up to 4*P while
    each still splits over the dp ranks and divides the batch."""
    if pipe <= 1:
        return 1
    for k in (4, 3, 2):
        if batch_size % (k * pipe * max(dp, 1)) == 0:
            return k * pipe
    return pipe


def _factorizations(n: int, k: int):
    """Every k-tuple of positive ints whose product is n."""
    if k == 1:
        yield (n,)
        return
    for d in range(1, n + 1):
        if n % d == 0:
            for rest in _factorizations(n // d, k - 1):
                yield (d,) + rest


def enumerate_specs(profile: ModelProfile, n_devices: int,
                    batch_size: int) -> List[Any]:
    """Every ParallelSpec the model can run on ``n_devices`` by the JAX
    package's gates (heads, ff and vocab divisibility for tensor, ring
    support and blocks of 1024+ tokens for seq, experts for expert,
    stages for pipe, the batch for data x fsdp), then a ZeRO variant of
    each that has a data axis."""
    from dlrover_tpu_torch.accel.accelerate import ParallelSpec

    p = profile
    out = []
    for data, fsdp, tensor, seq, expert, pipe in _factorizations(
            n_devices, 6):
        if tensor > 1:
            if not p.num_heads or p.num_heads % tensor:
                continue
            if p.ff_dim and p.ff_dim % tensor:
                continue
        if tensor * pipe > 1 and p.vocab_size:
            if p.vocab_size % (tensor * pipe):
                continue
        if seq > 1:
            if not p.supports_ring or not p.seq_len:
                continue
            if p.seq_len % seq:
                continue
            if p.seq_len // seq < 1024:
                continue
            if p.num_experts:
                continue
        if expert > 1 and (not p.num_experts or p.num_experts % expert):
            continue
        if pipe > 1:
            if not p.supports_pipeline or not p.num_layers:
                continue
            if p.num_layers % pipe:
                continue
        if batch_size % (data * fsdp):
            continue
        if pipe > 1 and (batch_size // (data * fsdp)) % pipe:
            continue
        out.append(ParallelSpec(data=data, fsdp=fsdp, tensor=tensor,
                                seq=seq, expert=expert, pipe=pipe))
    out += [dataclasses.replace(s, zero=True) for s in out if s.data > 1]
    return out


def search_spec(
    profile: ModelProfile,
    n_devices: int,
    batch_size: int,
    hbm: float,
    abstract_state: Optional[List[AbstractLeaf]] = None,
    peak_flops: float = PEAK_FLOPS,
    top_k: int = 4,
    prefer: Sequence[str] = (),
    abstract_fn: Optional[Callable] = None,
    ici_bw: float = ICI_BW,
    devices_per_host: int = 0,
    dcn_bw: float = DCN_BW,
    **constants,
) -> List[Tuple[Any, CostEstimate]]:
    """Rank the candidates that fit in ``hbm``; the top ``top_k`` as
    ``(spec, estimate)``. ``abstract_fn(spec)`` gives each candidate's
    abstract state when the spec changes the model (pipeline stages);
    else ``abstract_state`` serves every one. When nothing fits, the
    least-oversubscribed (within 10% of the smallest) are ranked, with a
    warning. ``prefer`` breaks near-ties toward the named degrees.
    ``constants``: ``estimate``'s others (``hbm_bw``, ``mfu_derate``,
    ``coll_lat``, ``dcn_lat``)."""
    cands = enumerate_specs(profile, n_devices, batch_size)
    kw = dict(ici_bw=ici_bw, devices_per_host=devices_per_host,
              dcn_bw=dcn_bw, **constants)
    if not cands:
        from dlrover_tpu_torch.accel.accelerate import ParallelSpec

        fallback = ParallelSpec(data=1)
        ab = abstract_fn(fallback) if abstract_fn else abstract_state
        return [(fallback, estimate(profile, fallback, batch_size, hbm, ab,
                                    peak_flops, **kw))]
    scored = []
    for spec in cands:
        ab = abstract_fn(spec) if abstract_fn else abstract_state
        scored.append((spec, estimate(profile, spec, batch_size, hbm, ab,
                                      peak_flops, **kw)))
    fitting = [s for s in scored if s[1].fits(hbm)]
    if fitting:
        pool = fitting
    else:
        min_b = min(s[1].total_bytes for s in scored)
        pool = [s for s in scored if s[1].total_bytes <= 1.10 * min_b]
        logger.warning(
            "strategy search: no candidate fits %.1f GB HBM "
            "(best needs %.1f GB); dry-run will decide",
            hbm / 1e9, min_b / 1e9,
        )

    def key(item):
        spec, est = item
        t = est.step_s
        for name in prefer:
            if getattr(spec, name, 1) > 1:
                t *= 0.95
        return t

    top = sorted(pool, key=key)[:top_k]
    for spec, est in top:
        logger.info(
            "strategy search: %s -> %.1f GB state + %.1f GB act, "
            "est %.1f ms/step (comm %.1f ms, bubble %.2f)",
            spec, est.state_bytes / 1e9, est.act_bytes / 1e9,
            est.step_s * 1e3, est.comm_s * 1e3, est.bubble,
        )
    return top


# ------------------------------------------------------ reconfiguration


def reconfigured_cfg(cfg, spec, batch_size: int = 0):
    """The JAX package's rule: ``seq > 1`` switches attention to the
    ring, a ring without a seq degree back to "xla"; ``pipeline_stages``
    is the pipe degree (0 without one) with the microbatches the cost
    model assumed. Returns ``cfg`` itself when nothing changes."""
    if cfg is None or not dataclasses.is_dataclass(cfg):
        return cfg
    fields = {f.name for f in dataclasses.fields(cfg)}
    changes = {}
    if spec.seq > 1 and "attn_impl" in fields and cfg.attn_impl != "ring":
        changes["attn_impl"] = "ring"
    if spec.seq == 1 and getattr(cfg, "attn_impl", None) == "ring":
        changes["attn_impl"] = "xla"
    if "pipeline_stages" in fields:
        want = spec.pipe if spec.pipe > 1 else 0
        if (cfg.pipeline_stages or 0) != want:
            changes["pipeline_stages"] = want
        if want and batch_size and "pipeline_microbatches" in fields:
            changes["pipeline_microbatches"] = _pipe_microbatches(
                spec.pipe, batch_size, spec.data * spec.fsdp)
    if not changes:
        return cfg
    return dataclasses.replace(cfg, **changes)


def _weights_for(module, cfg) -> dict:
    """``module``'s weights under the names of a model of ``cfg``: the
    same tensors; a change of ``pipeline_stages`` goes through the
    unpipelined names (``convert.dense_state_dict``) and the schedule's
    layer paths (``accel.pipeline.layer_names``)."""
    from dlrover_tpu_torch.accel.pipeline import layer_names
    from dlrover_tpu_torch.models.convert import dense_state_dict, naming_of

    sd = module.state_dict()
    if (module.cfg.pipeline_stages or 0) > 1:
        sd = dense_state_dict(sd, module.cfg)
    if (cfg.pipeline_stages or 0) <= 1:
        return sd
    stack = naming_of(sd).stack
    dense = dataclasses.replace(cfg, pipeline_stages=0, pipeline_repeats=1)
    rename = dict(zip(layer_names(dense, stack), layer_names(cfg, stack)))
    out = {}
    for name, value in sd.items():
        head, _, rest = name.partition(".")
        idx, _, leaf = rest.partition(".")
        layer = f"{head}.{idx}"
        out[f"{rename[layer]}.{leaf}" if layer in rename else name] = value
    return out


def reconfigure_module(module, spec, batch_size: int = 0):
    """``module`` adapted to ``spec`` (``reconfigured_cfg``): a new model
    of its class and the new config on its device, holding its weights,
    so the chosen spec trains from them; ``module`` itself when nothing
    changes (or it has no config dataclass)."""
    cfg = getattr(module, "cfg", None)
    new_cfg = reconfigured_cfg(cfg, spec, batch_size)
    if new_cfg is cfg:
        return module
    changes = {f.name: getattr(new_cfg, f.name)
               for f in dataclasses.fields(cfg)
               if getattr(new_cfg, f.name) != getattr(cfg, f.name)}
    logger.info("strategy search: reconfigured model %s", changes)
    device = next(module.parameters()).device
    out = _meta_model(module, new_cfg).to_empty(device=device)
    with torch.no_grad():
        out.load_state_dict(_weights_for(module, new_cfg))
    return out

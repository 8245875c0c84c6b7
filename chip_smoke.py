"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (and so exits non-zero) when it fails:

1. build the CUDA kernels from ``dlrover_tpu_torch/ops/csrc`` with nvcc,
   one process per source, all at once; print nvcc's seconds, each
   kernel's registers and spills, and the highest register of each in
   its SASS (what a consumer thread takes after setmaxnreg);
2. hold each kernel against its plain PyTorch version on the card:
   flash attention at the GPT-2 124M shape (batch*heads 16*12, seq 1024,
   head_dim 64, bf16, causal), at GPT-2 xl's (4*25) and at the pipelined
   GPT-2 xl's (one row a microbatch: 1*25), each on contiguous q/k/v and on the model's layout (views of one fused
   [B, S, 3 H D] tensor), non-causal, at a ragged sequence and at S 192
   (a half-empty 128-row block); 8-bit Adam, unfused and fused, element by element,
   on a chunked [48, 1600, 4800] leaf, the [50257, 1600] embedding, a
   ragged leaf, a flat stacked bias whose blocks straddle layers and a
   leaf of crafted blocks (a rounding tie, all zeros, the 0.5 floor);
3. time each flash kernel at both shapes and both layouts, twice: its
   launches alone (no host work) and through its wrapper; its plain
   version and, as yardsticks the port never calls, PyTorch's
   scaled_dot_product_attention and ATen's flash backward; compute each
   kernel's bound from its bytes and FLOPs; then the head_dim-128 forms
   (LLaMA's): each held to its plain version at the LLaMA preset's
   shapes (B 4, S 2048 and B 1, S 8192, 16 heads, causal) and the
   pipelined preset's (B 1, S 2048), non-causal,
   ragged (causal and not), at S 192 and at shapes that strain the
   forward's and dK/dV's walks over their items (one block of one tile;
   120 items; 40 (b, h) in L2 groups); at both preset shapes dK/dV
   launched twice gives the same bits; timed there the same way;
4. check the GPT's and the LLaMA's kernel paths against their einsum
   paths on a small input (2 layers at full width), then train GPT-2 124M (12 x 768, batch 16 x 1024, random weights from
   the seed, one fixed batch, AdamW) through ``Trainer.fit``: 2 warm-up
   steps, then a window of 10 whose tokens over its wall time, fence to
   fence, give tokens/s; check that every flash kernel ran 12 times a
   step in the window and that the loss is finite and falls; then trace
   3 more steps with torch.profiler: device time by kernel group, each
   flash kernel's device ms per launch, the card's busy share of the
   traced time and the kernels' time over the window's step;
5. remat on GPT-2 xl 1.5B (48 x 1600, bf16 params, batch 4 x 1024, the
   port's fused ``adam8bit(2e-4)``, as bench.py trains it): windows of 4
   steps (after 2 warm-up) without remat and under "nothing", "dots",
   "dots_lite" and "offload", in turns, one round, traced
   (busy share, of the kernels and with the copies): each policy's
   median step ms, tokens/s, MFU, peak memory, busy share, and
   "offload"'s GB and GB/s each way a step; every window's losses equal
   no remat's of its round bit for bit; "offload" peaks below "dots";
   every flash kernel 48 times a step (the forward 96 under remat), the
   fused 8-bit Adam once a step over every leaf, the unfused one never;
   in the traced steps the optimizer's own
   ops (a profiler range around ``update_and_apply``) hold no cat and no
   copy kernel. Then the flagship window ("dots") and 2 steps of the
   optax-style loop (``update``, then apply) on it, where the unfused
   kernel runs once a step and the fused one never. Then the optimizer's
   state in host memory: GPT-2 xl without remat under
   ``bf16_master_weights(adamw)`` and ``adam8bit``, each without and with
   ``offload_optimizer=True`` (equal losses, a lower peak, the moved
   leaves in pinned host memory between steps, the state's GB and the
   copies' GB/s). Then remat on the LLaMA preset (22 x 2048, 16 / 8
   heads, vocab 32000, bf16 params, ``adam8bit(2e-4)``) at 4 x 2048 the
   same way, in two rounds of alternating order (the last traced),
   without remat and under "nothing", "dots" and "offload"
   (each head_dim-128 kernel 22 times a step, the forward 44 under
   remat, no head_dim-64 kernel), and a window at 1 x 8192 under
   "dots". Then AGD (through ``Trainer.fit``) and WeightedSAM (its own
   step; the flash kernels twice a step) on GPT-2 124M: the loss falls,
   and each first update equals the same update on the CPU from the
   card's gradients within 1e-6. Then each mesh branch of
   ``accelerate_on_mesh`` on an NCCL process group of one rank, on a mesh
   that has its axis (size 1), beside the one-device path of the same
   seed and batch: GPT-2 xl ("dots", ``adam8bit``, 4 x 1024) under fsdp
   (FSDP2) and data, the LLaMA preset (4 x 2048, "dots") under tensor
   (its kernels DTensors, the embedding and the head vocab-parallel)
   and under fsdp x tensor (FSDP2 over the DTensors; 2 steps, the
   embedding's lookup vocab-parallel): 2 warm-up steps, a window of 4
   and 1 traced (GPT-2 xl's windows untraced since PR 16), each
   window's losses equal the one-device path's bit
   for bit (fsdp's parameters too), the kernels' launches as many, and
   a sharded snapshot of the fsdp run persisted and restored into a
   fresh one-device trainer bit for bit, leaf by leaf; step ms, peak
   GiB and busy share of each beside the one-device path's (``[mesh]``
   lines); GPT-2 xl on ("fsdp", 1) again with ``offload_optimizer=True``
   (``[offload]`` line: 2 steps, losses bit for bit the fsdp window's,
   the peak below its, the 8-bit moments' GB each way a step and the
   copies' GB/s); then ``PlainGPT`` (GPT-2 124M's widths as a plain module of
   ``nn.Linear`` / ``nn.Embedding`` / ``nn.LayerNorm``, bf16, its
   attention the head_dim-64 flash kernels) at 16 x 1024 under AdamW
   on one device and placed by ``plan_tp``'s registry on an ("fsdp",
   1), ("tensor", 1) mesh: the planner's roles checked and printed
   (``[registry]`` line), the losses bit for bit, the kernels as many;
   and ``ConvPlainGPT`` (the same with a causal ``Conv1d`` and a bare
   ``gain`` after the embeddings) on one device and on ("tensor", 1),
   the conv's weight, bias and ``gain`` tensor shards gathered whole in
   the forward (``[registry conv]`` line, 2 steps, losses bit for bit).
   Then ZeRO-1 (``[zero]`` lines) on a ("data", 1)
   mesh of an NCCL world of one: the LLaMA preset (4 x 2048, "dots")
   under ``bf16_master_weights(adamw)`` with ``zero=True`` (the wrapper
   owns whole leaves and all-gathers them) beside the one-device run of
   the same seed and batch (2 steps each since PR 16), each window's
   losses bit for bit and the head_dim-128 kernels 22 / 44 times a
   step; the sliced state's GiB,
   step ms, and its snapshot (stamped with ZeRO degree 0) persisted and
   restored into a fresh one-device trainer bit for bit; the same
   under ``zero=True`` on ("data", 1), ("fsdp", 1), ("tensor", 1) (2
   steps, bit for bit); the LLaMA preset under
   ``bf16_master_weights(adam8bit)`` with ``zero=True`` beside one
   device (2 steps each): losses bit for bit, the masters sliced and the
   8-bit moments whole, the unfused kernel once a step (the fused one
   on one device), their GiB, its snapshot restored on one device bit
   for bit; GPT-2 xl's 8-bit Adam under ``zero=True``: the JAX
   package's warning (nothing to slice), the fused kernel once a step,
   the one-device losses bit for bit. Then the LLaMA preset with 8 swiglu experts (top
   2, capacity factor 1.25; 6.36B parameters, 1.90B active) at full
   width through ``Trainer.fit`` with ``moe_loss_fn`` and
   ``adam8bit(2e-4)``, batch 4 x 2048, remat "dots": 2 warm-up steps, a
   window of 4 (each head_dim-128 kernel 22 times a step, the forward
   44, the fused 8-bit Adam once a step over every leaf, the
   [22, 8, 2048, 5504] stacks too; the loss finite and falling), a
   traced step (busy share; the MoE's device ms by routing,
   dispatch/combine and expert products; MFU over the active
   parameters); the same model and seed on a mesh with an expert axis
   of one (losses bit for bit, as many launches, a sharded snapshot
   persisted and restored into a fresh one-device trainer bit for bit);
   and ``ring_attention_shard`` and ``ulysses_attention_shard`` (flash
   kernels inside, each launched once) on the NCCL group of one at
   B 4, S 2048, 16 heads, D 128, forward and backward, each held to fp32
   attention by tile and timed beside the flash kernels alone
   (``[moe ...]`` and ``[seq ...]`` lines). Then the strategy search
   (``[search]`` line): ``auto_accelerate(spec="auto")`` on the LLaMA
   preset chooses one device, and the cost model's step estimate over
   the measured step of each window above (GPT-2 124M, GPT-2 xl without
   remat and "dots", LLaMA without remat and "dots", the LLaMA-MoE; a
   policy of the remat rounds by the median of every step of its
   rounds), the LLaMA windows (which its derate is calibrated on)
   within 30%.
   Then pipelines on one card
   (``[pipe ...]`` lines): GPT-2 xl as above under GPipe (4 stages, 4
   microbatches of one row) and the circular schedule (4 stages x 2
   repeats: 8 chunks of 6 layers), and the LLaMA preset at 4 x 2048
   under GPipe (2 stages, 4 microbatches): each first step's logits and
   loss equal the unpipelined model of the same seed run microbatch by
   microbatch, bit for bit; a window of 2 (each flash kernel 4 times a
   layer a step, the ticks the JAX package's formula, the loss falling)
   and a traced step, beside the unpipelined "dots" step of the same
   call; then the GPipe run on an NCCL world of one with a ("pipe", 1)
   mesh, its losses bit for bit the one-device run's; then the fused
   8-bit Adam launch a pipe rank issues (``[pipe rank adam8]`` line):
   pipe rank 0 of 2 of GPT-2 xl under GPipe 4 x 4, its optimizer over
   stages [0, 2) and its ends, its state those stages' rows of a whole
   random state: one launch held to the plain version leaf by leaf, the
   rows of stages [2, 4) untouched, 10 launches timed beside the bound;
6. over the bound 1.5B optimizer's 16 leaves, hold each kernel's one
   launch a step (``update_and_apply`` with one gradient missing, and
   ``update``) to the plain version leaf by leaf; time one whole 8-bit
   Adam step (each kernel's one launch alone, and the step through
   ``update_and_apply`` or ``update`` with the wrappers' host work, and
   the pieces of ``update``'s host work), and the largest leaf alone,
   for each kernel and for the plain version, beside the bound from the
   bytes each must move;
7. the flash checkpoint, with the agent's saver in this process, a job
   name of this run and files under ``build/`` (removed at the end, as
   are the shared-memory segments): (a) GPT-2 124M, windows of 10 steps
   without a checkpoint, with a memory snapshot asked for every step,
   and with a DISK save every 5 besides, in turns (step ms, host ms of
   a save call, share snapshotted, the copies' device ms and rate beside
   ATen's copy into pinned memory, call to publish), a persist, restores
   from memory and from disk into fresh Trainers, each leaf held bit for
   bit to the state at its step, and one more step whose loss equals the
   uninterrupted run's; (b) GPT-2 xl 1.5B (without remat), windows of 6
   steps of the same kinds without the DISK ones, a snapshot taken
   while the next step runs held bit for bit (the race check), a restore from memory; (c) a child process training
   124M, SIGKILLed after step 4, the saver's flush of its last snapshot,
   and a resumed child whose losses equal an unkilled child's;
8. print each phase's wall time, the card, a ``{"kernels": [...]}`` line
   (all eight kernels; the head_dim-128 ones timed at B 4, S 2048), and
   last ``{"ok": true, "device": {...}}``.

Without CUDA it exits non-zero and prints no result. Float32 matmuls
and convolutions run without TF32 wherever a comparison is made.
"""

import argparse
import contextlib
import dataclasses
import glob
import json
import logging
import math
import os
import resource
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dlrover_tpu_torch.accel import (
    ParallelSpec,
    accelerate_on_mesh,
    auto_accelerate,
    create_mesh,
    sharding,
)
from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common import checksum, ckpt_persist, env_utils
from dlrover_tpu_torch.common.comm import clear_job_sockets
from dlrover_tpu_torch.common.log import logger as port_logger
from dlrover_tpu_torch.common.shared_memory import SharedMemory
from dlrover_tpu_torch.models.convert import leaf_bytes, train_state_leaves
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn, moe_loss_fn
from dlrover_tpu_torch.models.llama import Llama, LlamaConfig
from dlrover_tpu_torch.models.tensor_parallel import (
    ParallelLinear,
    VocabParallelEmbedding,
)
from dlrover_tpu_torch.ops import attention as attn
from dlrover_tpu_torch.ops import build
from dlrover_tpu_torch.optim import (
    WeightedSAM,
    adam8bit,
    adamw,
    agd,
    bf16_master_weights,
)
from dlrover_tpu_torch.optim import low_bit as lowbit
from dlrover_tpu_torch.train.checkpoint import (
    FlashCheckpointer,
    ShardedCheckpointer,
    StorageType,
)
from dlrover_tpu_torch.train.trainer import (
    LoggingCallback,
    Trainer,
    TrainerCallback,
)
from dlrover_tpu_torch.utils.profiler import (
    LAUNCH_CALLS,
    device_kernels,
    device_peak_flops,
    device_records,
    device_trace,
    launches_without_record,
    mfu,
)

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s
FLASH_SOURCE = "dlrover_tpu_torch/ops/csrc/flash_attn.cu"
ADAM8_SOURCE = "dlrover_tpu_torch/ops/csrc/adam8bit.cu"
# The Pallas kernel each flash kernel replaces, at either head_dim.
FLASH_REPLACES = {"flash_fwd": "dlrover_tpu/ops/attention.py:61",
                  "flash_bwd_dq": "dlrover_tpu/ops/attention.py:179",
                  "flash_bwd_dkv": "dlrover_tpu/ops/attention.py:230"}
# Each kernel (named as its launch counter), its source and the Pallas
# kernel it replaces: the flash kernels at head_dim 64 (GPT-2) and 128
# (LLaMA), then the 8-bit Adam kernels.
KERNELS = tuple(
    (attn.kernel_name(k, d), FLASH_SOURCE, FLASH_REPLACES[k])
    for d in attn.HEAD_DIMS for k in attn.KERNELS
) + (
    ("adam8", ADAM8_SOURCE, "dlrover_tpu/optim/low_bit.py:79"),
    ("adam8_fused", ADAM8_SOURCE, "dlrover_tpu/optim/low_bit.py:131"),
)
FLASH = [attn.kernel_name(k, 64) for k in attn.KERNELS]
FLASH128 = [attn.kernel_name(k, 128) for k in attn.KERNELS]
# Kernel vs plain: bf16 outputs, and bf16 P / dS operands of the tensor-
# core products where the plain version keeps fp32. Every 64-row tile of
# every output must agree with the plain version's to attn.TILE_REL_TOL
# (1e-2) in the Frobenius norm, and the fp32 logsumexp to attn.LSE_TOL
# (1e-3).
# Launches a flash kernel is timed over (alone, and through its wrapper).
LAUNCH_ITERS = 100
# The GPT's kernel path against its einsum path: the Frobenius norm of
# the logits' difference over that of the einsum path's logits. The two
# paths round P to bf16 at different places; two layers of bf16 compute
# carry that to about 7e-3 on the logits.
MODEL_TOL = 2e-2
WARMUP = 2
# Steps traced after a window of the phases that repeat (remat rounds,
# mesh branches, the MoE): torch.profiler's processing of a trace costs
# the host about 5 s a GPT-2 xl step, more than the steps themselves.
TRACED = 1
GPT2 = dict(vocab_size=50257, max_seq_len=1024, num_layers=12, num_heads=12,
            d_model=768, attn_impl="pallas")
BATCH, SEQ, STEPS = 16, 1024, 10
# The JAX package's large preset as bench.py section_large trains it
# first: remat "dots"; and without remat (the step fits 80 GB either
# way), which the checkpoint phases keep.
XL = dataclasses.replace(GPTConfig.gpt2_xl(), remat_policy="dots",
                         param_dtype=torch.bfloat16, attn_impl="pallas")
XL_NOREMAT = dataclasses.replace(XL, remat=False)
XL_BATCH, XL_UNFUSED_STEPS, XL_LR = 4, 2, 2e-4
# Remat on the one-chip presets: a window of REMAT_STEPS under each
# policy ("none": no remat), from the same seed and batch, in turns, in
# rounds of alternating order, so the host's swing between windows
# spreads over all of them: LLAMA_ROUNDS on the LLaMA preset, whose
# windows calibrate the strategy search's derate, one on GPT-2 xl, whose
# host-set steps swing 2x between calls whatever the rounds.
XL_POLICIES = ("none", "nothing", "dots", "dots_lite", "offload")
LLAMA_POLICIES = ("none", "nothing", "dots", "offload")
XL_ROUNDS, LLAMA_ROUNDS, REMAT_STEPS = 1, 2, 4
# The optimizer's state in host memory: GPT-2 xl without remat.
OPT_OFFLOAD_STEPS = 3
# AGD and WeightedSAM on GPT-2 124M: steps on the card, and the largest
# difference of any parameter between the first update on the card and
# the same update on the CPU from the card's gradients: a few fp32 ulps
# of values below 4 (the card divides by a scalar as a multiply by its
# reciprocal; both round p + u once).
AGD_WSAM_STEPS, AGD_WSAM_BATCH, AGD_WSAM_LR, UPDATE_TOL = 5, 8, 3e-4, 1e-6
# The LLaMA preset as bench.py section_llama trains it (22 x 2048, 16 /
# 8 heads, head_dim 128, bf16 params, remat "dots", adam8bit(2e-4)):
# (batch, seq, window steps) of each run; the first is also the remat
# rounds' shape.
LLAMA_RUNS = ((4, 2048, 5), (1, 8192, 3))
LLAMA_LR = 2e-4
# The LLaMA preset with Mixtral's routing (Mistral AI, "Mixtral of
# Experts", arXiv 2401.04088: 8 swiglu experts, top 2) under the JAX
# package's capacity factor 1.25, batch 4 x 2048, adam8bit(2e-4), remat
# "dots", the flash kernels; no depth cut. A window of MOE_STEPS.
MOE = dataclasses.replace(LlamaConfig.preset(2048), num_experts=8,
                          moe_top_k=2, moe_capacity_factor=1.25)
MOE_BATCH, MOE_STEPS = 4, 4
# Pipelined on one card: GPT-2 xl as bench.py trains it under GPipe (4
# stages of 12 layers, 4 microbatches of one row) and the circular
# schedule (4 stages, 2 repeats: 8 chunks of 6 layers), and the LLaMA
# preset at 4 x 2048 under GPipe (2 stages of 11 layers, 4
# microbatches); a window of PIPE_STEPS each.
XL_GPIPE = dataclasses.replace(XL, pipeline_stages=4,
                               pipeline_microbatches=4)
XL_CIRCULAR = dataclasses.replace(XL_GPIPE, pipeline_repeats=2)
LLAMA_PIPE = dataclasses.replace(LlamaConfig.preset(2048), pipeline_stages=2,
                                 pipeline_microbatches=4)
PIPE_STEPS = 2
# The sequence-parallel bodies at the preset's attention shape (B, S, H,
# D), and the launches each is timed over.
SEQ_SHAPE, SEQ_ITERS = (4, 2048, 16, 128), 5
# fp32 operations per value of each 8-bit Adam kernel (its bound by
# operations, under the bound by bytes by about 8x).
ADAM8_OPS = {"adam8": 21, "adam8_fused": 23}


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str):
    print(msg, flush=True)


def reset_counts():
    attn.reset_launch_counts()
    lowbit.reset_launch_counts()


def read_counts():
    return {**attn.LAUNCHES, **lowbit.LAUNCHES}


# The highest SASS register of each kernel (build.kernel_label), filled
# by build_kernels.
SASS_REGISTERS = {}


def build_kernels():
    """Both sources at once, one nvcc each; returns nvcc's seconds."""
    t0 = time.perf_counter()
    names = ("flash_attn", "adam8bit")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build.build, names)))
    attn._lib()
    lowbit._lib()
    for name, (path, secs, ptxas) in built.items():
        log(f"[build] {name}: nvcc {secs:.1f}s")
        for line in ptxas.splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "setmaxnreg", "wgmma")):
                log(f"[build]   {line.strip()}")
        # What a consumer thread really takes after setmaxnreg (ptxas -v
        # reports the launch's 168 a thread for every Hopper kernel).
        regs = build.sass_registers(path)
        SASS_REGISTERS.update(regs)
        log(f"[build]   SASS highest register: " + json.dumps(regs))
    log(f"[build] all sources in {time.perf_counter() - t0:.1f}s with "
        "loading")


def flash_want(cfg, steps):
    """Each flash kernel's launches in ``steps`` training steps of
    ``cfg``: its head_dim's forms once a layer a step (a pipelined
    model's once a layer and microbatch), the other width's never;
    under remat the forward twice (the backward recomputes it: no
    policy can save a kernel's output)."""
    want = dict.fromkeys(attn.LAUNCHES, 0)
    micro = 1
    if cfg.pipeline_stages > 1:
        micro = cfg.pipeline_microbatches or cfg.pipeline_stages
    for k in attn.KERNELS:
        per = 2 if cfg.remat and k == "flash_fwd" else 1
        want[attn.kernel_name(k, cfg.head_dim)] = \
            per * cfg.num_layers * micro * steps
    return want


def qkv_do(gen, b, s, h=12, d=64):
    return tuple(
        torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        for _ in range(4)
    )


def fused_qkv(q, k, v, do):
    """q, k and v as views of one [B, S, 3 H D] tensor, as the model's
    attention block passes them (row stride 3 H D); dO as it is."""
    b, s, h, d = q.shape
    qkv = torch.cat([x.reshape(b, s, h * d) for x in (q, k, v)], dim=-1)
    return tuple(x.unflatten(-1, (h, d))
                 for x in qkv.split(h * d, dim=-1)) + (do,)


def run_kernels(q, k, v, do, causal):
    """The three kernels on one input: (o, lse, dq, dk, dv)."""
    o, lse = attn.flash_fwd(q, k, v, causal)
    delta = attn.attention_delta(o, do)
    dq = attn.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = attn.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return o, lse, delta, dq, dk, dv


def compare(q, k, v, do, causal, label):
    """Each kernel against its plain version on the same inputs; returns
    the max abs error per kernel. Fails on a tile error over the limit."""
    o, lse, delta, dq, dk, dv = run_kernels(q, k, v, do, causal)
    o_ref, lse_ref = attn._fwd_plain(q, k, v, causal)
    dq_ref = attn._bwd_dq_plain(q, k, v, do, lse, delta, causal)
    dk_ref, dv_ref = attn._bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    errs, report = {}, {}
    d = q.shape[-1]
    for kernel, pairs in (("flash_fwd", {"o": (o, o_ref)}),
                          ("flash_bwd_dq", {"dq": (dq, dq_ref)}),
                          ("flash_bwd_dkv", {"dk": (dk, dk_ref),
                                             "dv": (dv, dv_ref)})):
        name = attn.kernel_name(kernel, d)
        errs[name] = 0.0
        for out, (got, ref) in pairs.items():
            check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite")
            abs_err = (got.float() - ref.float()).abs().max().item()
            rel = attn.tile_rel_err(got, ref)
            report[out] = {"tile_rel_err": rel, "max_abs_err": abs_err,
                           "max_abs_ref": ref.float().abs().max().item()}
            errs[name] = max(errs[name], abs_err)
    report["lse"] = {"max_abs_err": (lse - lse_ref).abs().max().item()}
    log(f"[kernels] {label}: " + json.dumps(report)
        + f" (limits: tile_rel_err <= {attn.TILE_REL_TOL}, lse max_abs_err"
        f" <= {attn.LSE_TOL})")
    for out, r in report.items():
        limit = attn.LSE_TOL if out == "lse" else attn.TILE_REL_TOL
        err = r["max_abs_err"] if out == "lse" else r["tile_rel_err"]
        check(err <= limit, f"{out} {label}: error {err} > {limit}")
    return errs


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bounds(b, s, h, d, causal):
    """Least time of each kernel on the card: the larger of its FLOPs over
    the bf16 tensor-core peak and its bytes (each input read once, each
    output written once) over HBM bandwidth. FLOPs count the visible
    (query, key) pairs of this input; exp and the elementwise work on
    the CUDA cores are left out."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    tensor = b * s * h * d * 2  # one bf16 [B,S,H,D]
    rowvec = b * h * s * 4      # one fp32 [B,H,S]
    work = {
        # QK^T, PV
        "flash_fwd": (4 * d * pairs, 4 * tensor + rowvec),
        # QK^T, dO V^T, dS K
        "flash_bwd_dq": (6 * d * pairs, 5 * tensor + 2 * rowvec),
        # QK^T, dO V^T, P^T dO, dS^T Q
        "flash_bwd_dkv": (8 * d * pairs, 6 * tensor + 2 * rowvec),
    }
    out = {}
    for kernel, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_S
        out[attn.kernel_name(kernel, d)] = {
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
        }
    return out


def launchers(q, k, v, do, lse, delta, causal):
    """Each flash kernel's launch alone, on outputs made here: its C entry
    bound to the pointers and strides, no checks, no count."""
    new = lambda t: torch.empty(t.shape, dtype=t.dtype,  # noqa: E731
                                device=t.device)
    o, dq, dk, dv, lse_out = new(q), new(q), new(k), new(v), new(lse)
    entry = lambda k: attn.entry_name(k, q.shape[-1])  # noqa: E731
    return {
        "flash_fwd": attn._launcher(entry("flash_fwd"), q, k, {
            "ptrs": (q, k, v, o, lse_out), "strided": (q, k, v, o)},
            causal),
        "flash_bwd_dq": attn._launcher(entry("flash_bwd_dq"), q, k, {
            "ptrs": (q, k, v, do, lse, delta, dq),
            "strided": (q, k, v, do, dq)}, causal),
        "flash_bwd_dkv": attn._launcher(entry("flash_bwd_dkv"), q, k, {
            "ptrs": (q, k, v, do, lse, delta, dk, dv),
            "strided": (q, k, v, do, dk, dv)}, causal),
    }


def time_kernels(q, k, v, do, yardsticks=True):
    """Each flash kernel's ms a launch, alone (``ms``) and through its
    wrapper (``wrapper_ms``), over LAUNCH_ITERS launches; with
    ``yardsticks``, also its plain version and the library calls. Keyed
    by the kernels of q's head_dim."""
    out, yard = _time_kernels(q, k, v, do, yardsticks)
    return {attn.kernel_name(n, q.shape[-1]): t for n, t in out.items()}, \
        yard


def _time_kernels(q, k, v, do, yardsticks):
    causal = True
    _, lse, delta, *_ = run_kernels(q, k, v, do, causal)
    alone = launchers(q, k, v, do, lse, delta, causal)
    fns = {
        "flash_fwd": (
            lambda: attn.flash_fwd(q, k, v, causal),
            lambda: attn._fwd_plain(q, k, v, causal),
        ),
        "flash_bwd_dq": (
            lambda: attn.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            lambda: attn._bwd_dq_plain(q, k, v, do, lse, delta, causal),
        ),
        "flash_bwd_dkv": (
            lambda: attn.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            lambda: attn._bwd_dkv_plain(q, k, v, do, lse, delta, causal),
        ),
    }
    out = {}
    for name, (wrapper, plain) in fns.items():
        out[name] = {
            "ms": time_ms(alone[name], LAUNCH_ITERS, 5),
            "wrapper_ms": time_ms(wrapper, LAUNCH_ITERS, 5),
        }
        if yardsticks:
            out[name]["plain_ms"] = time_ms(plain, 3, 1)
    if not yardsticks:
        return out, None
    # Yardstick only: PyTorch's fused attention on the same inputs.
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["flash_fwd"]["library_ms"] = time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True), LAUNCH_ITERS, 5)
    leaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt, vt)]
    dot = do.transpose(1, 2)

    def sdpa_fwd_bwd():
        sdpa(*leaves, is_causal=True).backward(dot)

    # One ATen call computes dQ, dK and dV from q, k, v, O, lse and dO:
    # the yardstick of the dQ + dK/dV pair (its own forward's O and lse).
    aten = torch.ops.aten
    fo, flse, cq, ck, mq, mk, seed, offset, _ = \
        aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
    bwd_ms = time_ms(lambda: aten._scaled_dot_product_flash_attention_backward(
        dot, qt, kt, vt, fo, flse, cq, ck, mq, mk, 0.0, True, seed, offset),
        LAUNCH_ITERS, 5)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        out[name]["library_ms"] = bwd_ms
    yard = {"sdpa_fwd_ms": out["flash_fwd"]["library_ms"],
            "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd),
            "aten_flash_bwd_ms": bwd_ms}
    return out, yard


class Record(TrainerCallback):
    def __init__(self):
        self.losses, self.step_s = [], []

    def on_step_end(self, trainer, step, metrics):
        self.losses.append(metrics["loss"])  # device tensor: read later
        self.step_s.append(metrics["step_time_s"])


def token_loss(module, params, batch):
    return loss_fn(module(batch), batch)


def moe_token_loss(module, params, batch):
    return moe_loss_fn(module(batch), batch)


def model_check(seed, model_cls=GPT, cfg=None):
    """A model's kernel path against its einsum path, same weights, on
    2 layers at the config's widths (GPT-2's by default) and a 2 x 256
    batch."""
    cfg = dataclasses.replace(cfg or GPTConfig(**GPT2), num_layers=2,
                              remat=False, attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = model_cls(cfg, device="cuda", generator=gen)
    ref = model_cls(dataclasses.replace(cfg, attn_impl="xla"), device="cuda")
    ref.load_state_dict(model.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda",
                         generator=gen)
    reset_counts()
    with torch.no_grad():
        a, b = model(toks), ref(toks)
    launched = read_counts()[attn.kernel_name("flash_fwd", cfg.head_dim)]
    check(launched == 2, f"{model_cls.__name__}: {launched} forward kernels")
    check(a.shape == (2, 256, cfg.vocab_size), f"logits shape {a.shape}")
    check(bool(torch.isfinite(a).all()), "non-finite logits")
    err = (a.float() - b.float()).abs().max().item()
    rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
    la, lb = float(loss_fn(a, toks)), float(loss_fn(b, toks))
    log(f"[model {model_cls.__name__}] kernel vs einsum path: logits "
        f"||err|| / ||ref|| {rel:.3e} (limit {MODEL_TOL}), max |err| "
        f"{err:.3e}, loss {la:.5f} vs {lb:.5f} (limit 1e-2)")
    check(rel <= MODEL_TOL, f"kernel path vs einsum path: logits {rel}")
    check(abs(la - lb) <= 1e-2, f"loss {la} vs einsum path {lb}")


def train(label, cfg, optimizer, batch_size, steps, seed, model_cls=GPT,
          seq=None, loss=token_loss, **accel):
    """``cfg`` from random weights (the seed) on one fixed batch of
    ``batch_size`` x ``seq`` through ``Trainer.fit``: 2 warm-up steps,
    then a window of ``steps`` in which every flash kernel of the model's
    head_dim runs once a layer a step (the forward twice under remat),
    the fused 8-bit Adam kernel its launches a step (none with AdamW),
    the unfused one never, and the loss is finite and falls; ``seq``
    defaults to SEQ; ``loss`` is the Trainer's (``moe_token_loss`` for a
    model with experts). ``accel`` goes to the Trainer
    (``offload_optimizer``). Returns the
    window's launches, the trainer, the batch and the window's stats
    (with its losses, and the copies of "offload" and of an offloaded
    optimizer: bytes and device ms each way a step)."""
    seq = seq or SEQ
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = model_cls(cfg, device="cuda", generator=gen)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch_size, seq), dtype=np.int64)
    rec = Record()
    # One device: "auto" would run the strategy search, whose one-device
    # choice also takes a pipelined model's stages off (JAX's rule).
    trainer = Trainer(model, optimizer, loss, batch,
                      spec=ParallelSpec(),
                      callbacks=[rec, LoggingCallback(every=5)],
                      **accel)
    trainer.fit(iter([batch] * WARMUP), steps=WARMUP)  # outside the window
    first = float(rec.losses[0])
    rec.losses, rec.step_s = [], []
    copiers = {}
    if model.remat.pool is not None:
        copiers["remat offload"] = model.remat.pool.take_copy_stats
    if hasattr(trainer.state["opt"], "take_copy_stats"):
        copiers["optimizer offload"] = trainer.state["opt"].take_copy_stats
    for take in copiers.values():
        take()  # the window's copies only
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = trainer.fit(iter([batch] * steps), steps=steps)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    launches = read_counts()
    losses = [float(x) for x in rec.losses]
    copies = {}
    for what, take in copiers.items():
        c = take()
        copies[what] = {
            **{f"gb_{way}": c[f"{way}_bytes"] / steps / 1e9
               for way in ("out", "in")},
            **{f"{way}_ms": c[f"{way}_ms"] / steps for way in ("out", "in")},
            **{f"{way}_gb_s": c[f"{way}_bytes"] / 1e9 / (c[f"{way}_ms"] / 1e3)
               for way in ("out", "in")}}
    log(f"[train {label}] loss at init {first}; window losses {losses}")
    check(out["step"] == steps, f"{label}: fit stopped at {out['step']}")
    per_step = getattr(trainer.state["opt"], "launches_per_step", 0)
    check(per_step in (0, 1), f"{label}: {per_step} optimizer launches a "
          "step, want one")
    want = flash_want(cfg, steps)
    want.update(adam8=0, adam8_fused=per_step * steps)
    for name, count in launches.items():
        check(count == want[name],
              f"{label}: {name} launched {count} times, want {want[name]}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    # End to end: every token of the window over its whole wall time,
    # fence to fence. The per-step median is the loop's own statistic.
    tok_s = batch_size * seq * steps / window_s
    peak = device_peak_flops(torch.device("cuda"))
    stats = {
        "steps": steps, "batch": [batch_size, seq], "window_s": window_s,
        "remat": cfg.remat_policy if cfg.remat else None,
        "step_ms": window_s / steps * 1e3, "tokens_per_s": tok_s,
        "mfu": mfu(tok_s, cfg.flops_per_token(), peak or PEAK_BF16),
        "median_step_gap_ms": statistics.median(rec.step_s) * 1e3,
        "step_gaps_ms": [x * 1e3 for x in rec.step_s],
        "flops_per_token": cfg.flops_per_token(),
        "params": sum(p.numel() for p in model.parameters()),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "first_loss": losses[0], "last_loss": losses[-1],
        "launches": launches, "copies": copies,
    }
    log(f"[train {label}] " + json.dumps(stats))
    stats["losses"], stats["init_loss"] = losses, first
    return launches, trainer, batch, stats


def train_unfused(trainer, batch, steps):
    """More steps of the 8-bit Adam run through the optax-style contract:
    gradients, ``update`` (the unfused kernel, once a step), then
    apply; the fused kernel never runs."""
    opt = trainer.state["opt"]
    toks = torch.from_numpy(batch).cuda()
    torch.cuda.synchronize()
    reset_counts()
    losses = []
    for _ in range(steps):
        lv = token_loss(trainer.module, None, toks)
        lv.backward()
        grads = {n: p.grad for n, p in opt.params.items()}
        updates, _ = opt.tx.update(grads, opt.state, opt.params)
        with torch.no_grad():
            for n, p in opt.params.items():
                p.add_(updates[n])
                p.grad = None
        losses.append(lv.detach())
    torch.cuda.synchronize()
    launches = read_counts()
    losses = [float(x) for x in losses]
    want = flash_want(XL, steps)
    want.update(adam8=opt.launches_per_step * steps, adam8_fused=0)
    log(f"[train gpt2-xl unfused] " + json.dumps(
        {"steps": steps, "losses": losses, "launches": launches}))
    for name, count in launches.items():
        check(count == want[name],
              f"unfused: {name} launched {count} times, want {want[name]}")
    check(all(math.isfinite(x) for x in losses), "unfused: non-finite loss")
    return launches


OPT_RANGE = "adam8bit.update_and_apply"
# The ops of a gather and a scatter, and their kernels (torch.cat, a
# foreach copy, a device-to-device copy).
GATHER_SCATTER_OPS = ("aten::cat", "aten::_foreach_copy_", "aten::stack")
GATHER_SCATTER = ("CatArrayBatchedCopy", "CopyFunctor", "Memcpy DtoD",
                  "direct_copy")


def range_contents(prof, name):
    """How many times the host range ``name`` ran, the ops it called and
    the kernels those ops launched, and the launch calls the range made
    itself, outside any op (the 8-bit Adam kernel's, from its ctypes
    library)."""
    ops, kernels = [], []

    def walk(event):
        ops.append(event.name)
        kernels.extend(k.name for k in event.kernels)
        for child in event.cpu_children:
            walk(child)

    ranges = [e for e in prof.events() if e.name == name
              and e.device_type == torch.autograd.DeviceType.CPU]
    own = [c for e in ranges for c in e.cpu_children
           if c.name in LAUNCH_CALLS]
    for event in ranges:
        for child in event.cpu_children:
            walk(child)
    return len(ranges), ops, kernels, own


def profile_window(label, trainer, batch, window_step_ms, steps=3,
                   extra=None):
    """Device time by kernel over ``steps`` more steps of the warm trainer
    (torch.profiler, CUDA activity): the share of the traced wall time the
    card spent in kernels, the kernels' time over the step of the window
    without the profiler (whose host-side tracing slows a step of many
    small ops), and the kernels grouped by what they do. With the 8-bit
    Adam optimizer, its ``update_and_apply`` runs inside a profiler range:
    the ops of that range and their kernels must hold no gather or
    scatter, and the profile one fused Adam launch a step. ``extra(prof,
    steps)`` adds its own figures to the result. The profiler can keep
    no device record of a trace's first launches (``device_trace``), so
    the optimizer's launches are read on the host's side of the trace and
    from the wrapper's count, and each device record kept of them must be
    the fused Adam kernel's; the launches of the steps without a record
    are counted and printed."""
    opt = trainer.state["opt"]
    fused = getattr(opt, "update_and_apply", None)
    if fused is not None:
        def traced(grads, params):
            with torch.profiler.record_function(OPT_RANGE):
                fused(grads, params)

        opt.update_and_apply = traced
    before = read_counts()["adam8_fused"]
    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.perf_counter()
        trainer.fit(iter([batch] * steps), steps=steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    events = prof.events()
    calls, lost = launches_without_record(events)
    log(f"[profile {label}] {len(lost)} of the steps' {calls} launches "
        f"without a device record (places {lost[:10]})")
    if fused is not None:
        del opt.update_and_apply  # the bound method again
        launched = read_counts()["adam8_fused"] - before
        ranges, ops, opt_kernels, own = range_contents(prof, OPT_RANGE)
        records = device_records(events)
        kept = [records[c.id] for c in own if c.id in records]
        count = lambda names: {n: names.count(n)  # noqa: E731
                               for n in sorted(set(names))}
        adam = sum(e.count for e in kernels if "adam8_kernel" in e.key)
        log(f"[profile {label}] optimizer range: " + json.dumps(
            {"ranges": ranges, "ops": count(ops),
             "kernels": count([k[:90] for k in opt_kernels]),
             "own_launches": len(own), "own_records": len(kept),
             "fused_adam_launched": launched,
             "adam8_kernel_records": adam}))
        check(ranges == steps, f"{label}: {ranges} optimizer ranges traced")
        check(len(own) == steps and launched == steps,
              f"{label}: the optimizer made {len(own)} launches of its own "
              f"in {ranges} ranges and launched the fused Adam kernel "
              f"{launched} times, in {steps} steps")
        check(all("adam8_kernel" in k for k in kept) and adam == len(kept),
              f"{label}: the device records of the optimizer's own "
              f"launches are {kept}; {adam} fused Adam records traced")
        bad = [k for k in ops if k in GATHER_SCATTER_OPS] + [
            k for k in opt_kernels if any(t in k for t in GATHER_SCATTER)]
        check(not bad, f"{label}: the optimizer ran {bad}")
    total = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        name = e.key.lower()
        if "fwd_kernel" in name or "bwd_dq_kernel" in name or \
                "bwd_dkv_kernel" in name:
            group = "flash attention (ours)"
        elif any(t in name for t in ("gemm", "xmma", "cutlass", "nvjet")):
            group = "matmul (cuBLAS)"
        elif "memcpy" in name or "memset" in name:
            group = "copies"
        elif "multi_tensor_apply" in name or "adam" in name:
            group = "optimizer"
        else:
            group = "elementwise / reductions"
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total
    per_launch = {}
    for kernel, entry in (("flash_fwd", "::fwd_kernel<"),
                          ("flash_bwd_dq", "::bwd_dq_kernel<"),
                          ("flash_bwd_dkv", "::bwd_dkv_kernel<")):
        for d in attn.HEAD_DIMS:
            hits = [e for e in kernels if f"{entry}{d}>" in e.key]
            launches = sum(e.count for e in hits)
            if launches:
                per_launch[attn.kernel_name(kernel, d)] = sum(
                    e.self_device_time_total for e in hits) / launches / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
    out = {
        "steps": steps,
        "launches_without_device_record": [len(lost), calls],
        "wall_ms_per_step": wall_us / steps / 1e3,
        "kernel_ms_per_step": total / steps / 1e3,
        "device_busy_share": total / wall_us,
        # Kernels alone: the copy engines run beside them.
        "kernel_busy_share": (total - groups.get("copies", 0.0)) / wall_us,
        "kernel_share_of_window_step": total / steps / 1e3 / window_step_ms,
        "groups_ms_per_step": {g: t / steps / 1e3 for g, t in
                               sorted(groups.items(), key=lambda x: -x[1])},
        "flash_device_ms_per_launch": per_launch,
        "top_kernels_ms_per_step": [
            [e.key[:90], e.self_device_time_total / steps / 1e3, e.count]
            for e in top
        ],
    }
    if extra is not None:
        out.update(extra(prof, steps))
    log(f"[profile {label}] " + json.dumps(out))
    return out


# ------------------------------------------------------- remat, optimizers


def with_policy(cfg, policy):
    """``cfg`` under a remat policy of the rounds ("none": no remat)."""
    if policy == "none":
        return dataclasses.replace(cfg, remat=False)
    return dataclasses.replace(cfg, remat=True, remat_policy=policy)


def remat_rounds(label, base, policies, lr, b, seq, seed, windows, rounds,
                 model_cls=GPT):
    """Every policy's window in turns (``rounds`` rounds), the last
    round's traced (busy share). Checks each window's losses against no
    remat's of its round, bit for bit, and that "offload" peaks below
    "dots"; prints each policy's median step ms (of its windows' means,
    and of every step of its windows: a step the host stalls moves the
    second only as one sample), tokens/s, MFU, peak memory, busy share
    and "offload"'s copies. Returns the summary."""
    runs = {p: [] for p in policies}
    for r in range(rounds):
        for policy in (policies if r % 2 == 0 else policies[::-1]):
            name = f"{label} {policy} r{r}"
            windows[name], trainer, batch, stats = train(
                name, with_policy(base, policy), adam8bit(lr), b,
                REMAT_STEPS, seed, model_cls=model_cls, seq=seq)
            if r == rounds - 1:
                prof = profile_window(name, trainer, batch, stats["step_ms"],
                                      steps=TRACED)
                stats["busy"] = prof["kernel_busy_share"]
                stats["busy_with_copies"] = prof["device_busy_share"]
            runs[policy].append(stats)
            del trainer
            torch.cuda.empty_cache()
    peak_flops = device_peak_flops(torch.device("cuda")) or PEAK_BF16
    summary = {}
    for policy, rs in runs.items():
        for r, st in enumerate(rs):
            check(st["losses"] == runs["none"][r]["losses"],
                  f"{label} {policy} round {r}: losses {st['losses']} "
                  f"differ from no remat's {runs['none'][r]['losses']}")
        step = statistics.median(st["step_ms"] for st in rs)
        gaps = [g for st in rs for g in st["step_gaps_ms"]]
        tok_s = b * seq / (step / 1e3)
        summary[policy] = {
            "median_step_ms": step, "step_ms": [st["step_ms"] for st in rs],
            "median_step_gap_ms": statistics.median(gaps),
            "step_gaps_ms": gaps,
            "tokens_per_s": tok_s,
            "mfu": mfu(tok_s, base.flops_per_token(), peak_flops),
            "peak_mem_gib": max(st["peak_mem_gib"] for st in rs),
            "busy_share": rs[-1]["busy"],
            "busy_share_with_copies": rs[-1]["busy_with_copies"],
            "copies": [st["copies"].get("remat offload") for st in rs]
            if policy == "offload" else None,
        }
    log(f"[remat {label}] " + json.dumps(summary))
    dots, nothing = (summary[p]["median_step_ms"]
                     for p in ("dots", "nothing"))
    log(f"[remat {label}] dots {dots:.2f} ms against nothing {nothing:.2f} "
        f"ms a step: dots faster: {dots < nothing}")
    check(summary["offload"]["peak_mem_gib"] < summary["dots"]["peak_mem_gib"],
          f"{label}: offload peaks at {summary['offload']['peak_mem_gib']} "
          f"GiB, dots at {summary['dots']['peak_mem_gib']}")
    return summary


def optimizer_offload(seed, windows):
    """GPT-2 xl without remat under ``bf16_master_weights(adamw)`` and
    ``adam8bit``, each without and with ``offload_optimizer=True``: the
    same losses bit for bit, a lower peak when offloaded, the moved
    leaves in pinned host memory between steps, and the state's bytes and
    copy rates."""
    out = {}
    for name, make in (("bf16 adamw",
                        lambda: bf16_master_weights(adamw(XL_LR))),
                       ("adam8bit", lambda: adam8bit(XL_LR))):
        runs = {}
        for off in (False, True):
            label = f"gpt2-xl {name}" + (" offloaded" if off else "")
            windows[label], trainer, _, stats = train(
                label, XL_NOREMAT, make(), XL_BATCH, OPT_OFFLOAD_STEPS, seed,
                offload_optimizer=off)
            if off:
                moved = trainer.state["opt"].moved
                check(bool(moved) and all(
                    t.device.type == "cpu" and t.is_pinned() for t in moved),
                    f"{label}: a moved leaf is not in pinned host memory")
                stats["state_gb"] = trainer.state["opt"].nbytes / 1e9
            runs[off] = stats
            del trainer
            torch.cuda.empty_cache()
        check(runs[True]["losses"] == runs[False]["losses"],
              f"{name}: losses with offload {runs[True]['losses']} differ "
              f"from {runs[False]['losses']}")
        check(runs[True]["peak_mem_gib"] < runs[False]["peak_mem_gib"],
              f"{name}: offloaded peak {runs[True]['peak_mem_gib']} GiB not "
              f"below {runs[False]['peak_mem_gib']}")
        out[name] = {
            ("offloaded" if off else "on the card"): {
                "step_ms": st["step_ms"], "peak_mem_gib": st["peak_mem_gib"],
                "state_gb": st.get("state_gb"),
                "copies": st["copies"].get("optimizer offload")}
            for off, st in runs.items()}
    log("[optimizer offload] " + json.dumps(out))
    return out


def first_update_vs_cpu(label, cfg, seed, step_on):
    """The largest difference of any parameter between one update on the
    card and the same update on the CPU, from the card's gradients:
    ``step_on(model, batch, grads)`` updates ``model`` (grads None: its
    own, on the card, returning them on the CPU; else the given ones)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = GPT(cfg, device="cuda", generator=gen)
    cpu = GPT(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    batch = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, SEQ))).cuda()
    grads = step_on(model, batch, None)
    step_on(cpu, None, grads)
    cpu_params = dict(cpu.named_parameters())
    err = max((p.detach().cpu() - cpu_params[n].detach()).abs().max().item()
              for n, p in model.named_parameters())
    log(f"[{label}] first update, card vs CPU from the card's gradients: "
        f"max |err| {err:.3e} (limit {UPDATE_TOL})")
    check(err <= UPDATE_TOL, f"{label}: first update differs by {err}")
    return err


def agd_step(model, batch, grads):
    opt = agd(AGD_WSAM_LR)(model.parameters())
    if grads is None:
        loss_fn(model(batch), batch).backward()
        grads = [p.grad.detach().cpu() for p in model.parameters()]
    else:
        for p, g in zip(model.parameters(), grads):
            p.grad = g
    opt.step()
    return grads


def wsam_step(model, batch, grads):
    """One WeightedSAM step; on the CPU its two passes' gradients are the
    card's (``_grads`` replaced), so only the update's arithmetic runs."""
    wsam = WeightedSAM(adamw(AGD_WSAM_LR)).init(model.named_parameters())
    if grads is None:
        seen, take = [], wsam._grads

        def keep(loss_fn_, params):
            loss, g = take(loss_fn_, params)
            seen.append((loss.cpu(), [x.detach().cpu() for x in g]))
            return loss, g

        wsam._grads = keep
        wsam.step(lambda: loss_fn(model(batch), batch))
        return seen
    passes = iter(grads)
    wsam._grads = lambda loss_fn_, params: next(passes)
    wsam.step(None)
    return grads


def agd_and_wsam(seed, windows):
    """AGD through ``Trainer.fit`` and WeightedSAM through its own step
    on GPT-2 124M: the loss falls, the flash kernels run at their counts
    (twice a step under WSAM's two passes), and each first update equals
    the CPU's (``first_update_vs_cpu``)."""
    cfg = GPTConfig(**GPT2)
    windows["gpt2-124m agd"], trainer, _, _ = train(
        "gpt2-124m agd", cfg, agd(AGD_WSAM_LR), AGD_WSAM_BATCH,
        AGD_WSAM_STEPS, seed)
    del trainer
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = GPT(cfg, device="cuda", generator=gen)
    wsam = WeightedSAM(adamw(AGD_WSAM_LR)).init(model.named_parameters())
    batch = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (AGD_WSAM_BATCH, SEQ))).cuda()
    torch.cuda.synchronize()
    reset_counts()
    losses = [wsam.step(lambda: loss_fn(model(batch), batch))
              for _ in range(AGD_WSAM_STEPS)]
    torch.cuda.synchronize()
    launches = read_counts()
    windows["gpt2-124m wsam"] = launches
    losses = [float(x) for x in losses]
    log("[train gpt2-124m wsam] " + json.dumps(
        {"steps": AGD_WSAM_STEPS, "losses": losses, "launches": launches}))
    want = flash_want(cfg, 2 * AGD_WSAM_STEPS)  # two passes a step
    want.update(adam8=0, adam8_fused=0)
    for name, count in launches.items():
        check(count == want[name],
              f"wsam: {name} launched {count} times, want {want[name]}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"wsam: loss did not fall: {losses}")
    del model, wsam
    torch.cuda.empty_cache()
    return {"agd_first_update_err": first_update_vs_cpu(
                "gpt2-124m agd", cfg, seed, agd_step),
            "wsam_first_update_err": first_update_vs_cpu(
                "gpt2-124m wsam", cfg, seed, wsam_step)}


# ------------------------------------------------------- 8-bit Adam


def adam8_cases(gen):
    """(label, grads, params, prior m, prior v, JAX leaf shape, hyper) of
    each check, made one at a time: bf16 leaves of the 1.5B model's
    shapes over a random prior state, and a crafted fp32 leaf."""
    hp = lowbit._Hyper(XL_LR, 0.9, 0.999, 1e-8, 0.0, 256)

    def rand(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    def leaf(label, member, layers=0):
        shape = ((layers,) if layers else ()) + member
        qm = lowbit._quantize_leaf(rand(shape, 1e-3, torch.float32), 256)
        qv = lowbit._quantize_leaf(
            rand(shape, 1e-3, torch.float32).abs(), 256)
        n = max(layers, 1)
        return (label, [rand(member, 1e-2) for _ in range(n)],
                [rand(member, 2e-2) for _ in range(n)], qm, qv, shape, hp)

    yield leaf("chunked [48, 1600, 4800]", (1600, 4800), 48)
    yield leaf("wte [50257, 1600]", (50257, 1600))
    yield leaf("ragged [777, 333]", (777, 333))
    yield leaf("straddling bias [48, 4800]", (4800,), 48)
    yield leaf("straddling [7, 37]", (37,), 7)
    yield crafted_case()


def crafted_case():
    """A ragged fp32 leaf of 5 x 256 + 100 values: block 0 holds exact
    round-half ties of m (b1 0.5, a fresh block, m = g / 2, absmax 127:
    2.5 -> 2, -2.5 -> -2, 0.5 -> 0); block 1 is all zeros; in block 2 a
    small |g| sits under a large one, so sqrt(v) rounds to 0 and the 0.5
    floor decides; blocks 3-5 are random over a random state. Weight
    decay 0.5 moves fp32 params by many ulps."""
    rng = np.random.default_rng(0)
    n = 5 * 256 + 100
    g = rng.standard_normal(n).astype(np.float32)
    g[:256] = rng.integers(-40, 40, 256) * 2
    g[:4] = [254, 5, -5, 1]
    g[256:512] = 0.0
    g[512:768] = 1e-3
    g[512] = 1.0
    m = rng.standard_normal((6, 256)) * 0.1
    s = np.abs(rng.standard_normal((6, 256))) * 0.3
    m[:3], s[:3] = 0.0, 0.0
    m[5, 100:], s[5, 100:] = 0.0, 0.0
    cuda = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                  device="cuda")
    return ("crafted tie / zero / floor blocks, fp32, wd 0.5", [cuda(g)],
            [cuda(rng.standard_normal(n))], lowbit._quantize(cuda(m), 256),
            lowbit._quantize(cuda(s), 256), (n,),
            lowbit._Hyper(1e-2, 0.5, 0.999, 1e-8, 0.5, 256))


def check_adam8(gen):
    """Both kernels against the plain version, element by element, on
    each case; returns the largest |err| of each kernel's output."""
    errs = {"adam8": 0.0, "adam8_fused": 0.0}
    limits = json.dumps(lowbit.ADAM8_LIMITS)
    for label, g, p, qm, qv, shape, hp in adam8_cases(gen):
        bc = 1 - torch.tensor([hp.b1, hp.b2], device="cuda") ** 3.0
        for name, fused in (("adam8", False), ("adam8_fused", True)):
            got, ref = lowbit.kernel_and_plain(g, qm, qv, bc, shape, hp,
                                               p=p if fused else None)
            torch.cuda.synchronize()
            e = lowbit.adam8_errors(got, ref)
            log(f"[kernels] {name} {label}: {json.dumps(e)} (limits: "
                f"{limits}, out within one ulp + {lowbit.OUT_REL} relative)")
            bad = lowbit.adam8_failures(e)
            check(not bad, f"{name} {label}: {bad}")
            errs[name] = max(errs[name], e["max_abs_err"])
            del got, ref
        del g, p, qm, qv
        torch.cuda.empty_cache()
    return errs


def adam8_work(opt, paths):
    """Bytes each 8-bit Adam kernel must move over ``paths`` (each input
    read once, each output written once: g; p read and written, or u
    written; both int8 moments and their per-block scales read and
    written) and its fp32 operations; the bound is the larger time."""
    out = {}
    for name in ("adam8", "adam8_fused"):
        nbytes = ops = 0
        for path in paths:
            leaf = opt._leaves[path]
            values = math.prod(leaf.shape)
            blocks = opt.state.m[path].scale.numel()
            esize = opt.params[leaf.names[0]].element_size()
            nbytes += values * esize * (3 if name == "adam8_fused" else 2)
            nbytes += 2 * 2 * blocks * 256 + 2 * 2 * blocks * 4 + 8
            ops += ADAM8_OPS[name] * values
        t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / PEAK_FP32
        out[name] = {"bytes": nbytes, "ops": ops,
                     "bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
    return out


def check_step_tables(opt, grads):
    """Each kernel's one launch over every leaf, through the entry point
    that trains (``update_and_apply``, with the gradient of one member of
    a straddling leaf missing, read as zeros) and through ``update``, held
    leaf by leaf to the plain version on copies of the state and params
    from before the launch; returns the largest |err| of each kernel's
    output."""
    hp, names = opt.tx.hp, list(opt.params)
    # Leaves whose members straddle blocks: stacked biases and norms, and
    # a pipelined model's [P, L/P, ...] leaves (a stage's layers share its
    # blocks).
    straddling = [leaf for leaf in opt._leaves.values()
                  if len(leaf.names) > 1 and (
                      not lowbit._chunked(leaf.shape)
                      or len(leaf.names) > leaf.shape[0])]
    leaf = min(straddling, key=lambda leaf: math.prod(leaf.shape))
    dropped = leaf.names[len(leaf.names) // 2]
    errs = {}
    for name in ("adam8_fused", "adam8"):
        fused = name == "adam8_fused"
        prior = {path: tuple(lowbit.QTensor(qt.q.clone(), qt.scale.clone())
                             for qt in (opt.state.m[path], opt.state.v[path]))
                 for path in opt._leaves}
        before = {n: opt.params[n].clone() for n in names} if fused else {}
        launches = lowbit.LAUNCHES[name]
        if fused:
            opt.update_and_apply(
                [None if n == dropped else grads[n] for n in names],
                [opt.params[n] for n in names])
            got_out = opt.params
        else:  # without params: the kernel's output, no decay after it
            got_out, _ = opt.tx.update(grads, opt.state)
        check(lowbit.LAUNCHES[name] == launches + 1,
              f"{name}: {lowbit.LAUNCHES[name] - launches} launches a step")
        step = opt.state.step
        bc = 1 - opt.tx._betas[step.device] ** step  # as the step made it
        worst, errs[name] = ("", -1.0), 0.0
        for path, leaf in opt._leaves.items():
            g = [torch.zeros_like(opt.params[n]) if fused and n == dropped
                 else grads[n] for n in leaf.names]
            (qm, qv), m, v = prior[path], opt.state.m[path], opt.state.v[path]
            ref = lowbit._plain_blocks(
                g, qm, qv, bc, leaf.shape, hp,
                p=[before[n] for n in leaf.names] if fused else None)
            got = (lowbit._blocks_of(lowbit._leaf(
                [got_out[n] for n in leaf.names], leaf.shape), hp.block),
                   m.q.view(-1, hp.block), m.scale.view(-1),
                   v.q.view(-1, hp.block), v.scale.view(-1))
            e = lowbit.adam8_errors(got, ref)
            bad = lowbit.adam8_failures(e)
            check(not bad, f"{name} step table, leaf {path}: {bad} {e}")
            errs[name] = max(errs[name], e["max_abs_err"])
            if e["out_err_over_limit"] > worst[1]:
                worst = (path, e["out_err_over_limit"])
            del g, ref, got
        via = (f"update_and_apply, no gradient for {dropped}" if fused
               else "update")
        log(f"[kernels] {name} one launch over {len(opt._leaves)} leaves "
            f"({via}): every leaf within {json.dumps(lowbit.ADAM8_LIMITS)}; "
            f"max_abs_err {errs[name]}, worst leaf {worst[0]} at "
            f"out_err_over_limit {worst[1]}")
        del prior, before, got_out
        torch.cuda.empty_cache()
    return errs


def update_host_ms(opt, grads, iters=20):
    """Host milliseconds of the pieces of an ``update`` call around its
    launch, each timed alone on the host clock after one call and a
    synchronize: allocating the outputs, finding the cached table (its
    key), and pointing the table at the outputs when they moved (one H2D
    copy behind an event; two sets of outputs in turns) and when they did
    not (the copy skipped); and whether two calls in a row put their
    outputs at other addresses."""
    table = opt.tx.step_tables(grads, opt.state)[0]
    alloc = lambda: {n: torch.empty(g.shape, dtype=g.dtype,  # noqa: E731
                                    device=g.device) for n, g in grads.items()}
    outs, turn = [alloc(), alloc()], [0]

    def point(k):
        table.point(table.members(grads), table.members(outs[k]))

    def moved():
        turn[0] ^= 1
        point(turn[0])

    def clock(fn):
        fn()  # the allocator's first call may go to cudaMalloc
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3

    out = {"alloc": clock(alloc),
           "find_table": clock(lambda: opt.tx.step_tables(grads, opt.state)),
           "point_moved": clock(moved)}
    point(0)
    out["point_unmoved"] = clock(lambda: point(0))
    del outs
    opt.tx.update(grads, opt.state)  # its outputs dropped, as when timed
    last = table._last
    opt.tx.update(grads, opt.state)
    out["outputs_moved_between_calls"] = table._last is not last
    torch.cuda.synchronize()
    return out


def time_adam8(opt, seed):
    """One whole step of each kernel over every leaf of the bound 1.5B
    optimizer: its one launch alone (``ms``: the table's pointers set
    beforehand, no host work), the whole step through the wrapper
    (``wrapper_step_ms``: ``update_and_apply`` for the fused kernel,
    ``update`` for the unfused one, with their host work), the largest
    leaf alone (a table of that leaf), and the plain version on the same
    leaves (block layout made outside the timing); random bf16 gradients
    from the seed."""
    hp = opt.tx.hp
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    grads = {n: (torch.randn(p.shape, generator=gen, device="cuda")
                 * 1e-3).to(p.dtype) for n, p in opt.params.items()}
    bc = 1 - torch.tensor([hp.b1, hp.b2], device="cuda") ** 3.0
    paths = list(opt._leaves)
    largest = max(paths, key=lambda k: math.prod(opt._leaves[k].shape))
    members = {path: ([grads[n] for n in leaf.names],
                      [opt.params[n] for n in leaf.names])
               for path, leaf in opt._leaves.items()}
    names = list(opt.params)
    g_list, p_list = [grads[n] for n in names], [opt.params[n] for n in names]
    main_path_errs = check_step_tables(opt, grads)
    # The bound table (fused) and update's table (unfused), each pointed
    # at these gradients by one call; ``held`` keeps update's outputs,
    # which its table writes, alive while its launch is timed alone.
    opt.update_and_apply(g_list, p_list)
    held, _ = opt.tx.update(grads, opt.state, opt.params)
    tables = {"adam8_fused": opt._cache[1], "adam8": opt.tx._cache[1]}
    leaf = opt._leaves[largest]
    g_big, p_big = members[largest]
    u_big = [torch.empty_like(t) for t in g_big]
    qm, qv = opt.state.m[largest], opt.state.v[largest]
    one = {}
    for name, out in (("adam8", u_big), ("adam8_fused", p_big)):
        one[name] = lowbit._Table([(leaf.shape, out, qm, qv)],
                                  out[0].dtype, out[0].device)
        one[name].point(g_big, out)
    wrappers = {
        "adam8_fused": lambda: opt.update_and_apply(g_list, p_list),
        "adam8": lambda: opt.tx.update(grads, opt.state, opt.params),
    }

    out = {}
    whole, alone = adam8_work(opt, paths), adam8_work(opt, [largest])
    for name, fused in (("adam8", False), ("adam8_fused", True)):
        check(len(tables[name]) == 1, f"{name}: {len(tables[name])} tables")
        table = tables[name][0]
        out[name] = {
            "ms": time_ms(lambda: table.launch(fused, bc, hp), iters=10,
                          warmup=2),
            "largest_leaf_ms": time_ms(
                lambda: one[name].launch(fused, bc, hp), iters=10, warmup=2),
            "plain_ms": 0.0, **whole[name],
            "largest_leaf_bound_ms": alone[name]["bound_ms"],
        }
    del held, one
    for name in ("adam8", "adam8_fused"):
        out[name]["wrapper_step_ms"] = time_ms(wrappers[name], iters=10,
                                               warmup=2)
        out[name]["wrapper_over_launch_ms"] = \
            out[name]["wrapper_step_ms"] - out[name]["ms"]
        out[name]["max_abs_err"] = main_path_errs[name]
    out["adam8"]["update_host_ms"] = update_host_ms(opt, grads)
    for path in paths:
        leaf = opt._leaves[path]
        blocks = lambda ts: lowbit._blocks_of(  # noqa: E731
            lowbit._leaf(ts, leaf.shape), 256)
        gb, pb = blocks(members[path][0]), blocks(members[path][1])
        qm, qv = opt.state.m[path], opt.state.v[path]
        for name, fused in (("adam8", False), ("adam8_fused", True)):
            ms = time_ms(lambda: lowbit._adam8_plain(
                bc, gb, qm.q.view(-1, 256), qm.scale, qv.q.view(-1, 256),
                qv.scale, lr=hp.lr, b1=hp.b1, b2=hp.b2, eps=hp.eps, wd=hp.wd,
                pb=pb if fused else None), iters=2, warmup=1)
            out[name]["plain_ms"] += ms
            if path == largest:
                out[name]["largest_leaf_plain_ms"] = ms
        del gb, pb
        torch.cuda.empty_cache()
    out["largest_leaf"] = {"path": largest,
                           "shape": list(opt._leaves[largest].shape)}
    out["leaves"] = len(paths)
    out["values"] = sum(math.prod(leaf.shape)
                        for leaf in opt._leaves.values())
    return out


# ------------------------------------------------------- flash checkpoint

# 124M: windows of STEPS with and without the checkpoint, in turns; the
# DISK saves of the window that has them come every CKPT_PERSIST steps.
CKPT_PERSIST = 5
# The crash drill: the child is killed after CRASH_AT steps, and resumes
# for RESUMED more.
CRASH_AT, RESUMED = 4, 3
# 1.5B: windows of CKPT_XL_STEPS with and without, in turns (the host
# sets this step, and it swings).
CKPT_XL_STEPS = 6


def ckpt_setup(root):
    """A job name of this run (the segment and the sockets are named by
    it, so no earlier run's snapshot is found) and the checkpoint
    directory; prints where the segment and the files live."""
    job = f"smoke-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    os.environ["DLROVER_TPU_JOB_NAME"] = job
    shm_dir = env_utils.SHM_DIR.get()
    os.makedirs(root, exist_ok=True)
    st = os.statvfs(shm_dir)
    fs = lambda p: subprocess.run(  # noqa: E731
        ["stat", "-f", "-c", "%T", p], capture_output=True,
        text=True).stdout.strip()
    mem = dict(line.split(":", 1) for line in open("/proc/meminfo"))
    log("[ckpt] " + json.dumps({
        "job": job, "shm_dir": shm_dir, "shm_fs": fs(shm_dir),
        "shm_free_bytes": st.f_bavail * st.f_frsize,
        "host_mem_total": mem["MemTotal"].strip(),
        "host_mem_available": mem["MemAvailable"].strip(),
        "memlock_limit": resource.getrlimit(resource.RLIMIT_MEMLOCK),
        "checkpoint_root": root, "checkpoint_fs": fs(root),
        "crc_algo": checksum.DEFAULT_ALGO}))
    return job


def unlink_segments(job):
    for path in glob.glob(os.path.join(env_utils.SHM_DIR.get(),
                                       f"ckpt_{job}_*")):
        os.unlink(path)


def ckpt_cleanup(job, root):
    """Stop the saver, unlink the run's segments, sockets and files."""
    AsyncCheckpointSaver.stop()
    unlink_segments(job)
    clear_job_sockets(job)
    shutil.rmtree(root, ignore_errors=True)


def state_bytes(trainer):
    """{leaf path: the leaf's bytes on the card}, copied on the compute
    stream: the state at the step the loop is at."""
    return {leaf.path: leaf_bytes(leaf).to("cuda").clone()
            for leaf in train_state_leaves(trainer.state)}


def differing(got, want):
    """Leaf paths whose bytes differ (or that one side lacks)."""
    bad = sorted(set(got) ^ set(want))
    return bad + [p for p in sorted(set(got) & set(want))
                  if not torch.equal(got[p].to(want[p].device), want[p])]


def snapshot_differs(engine, want):
    """The published memory snapshot's step and the leaves whose bytes in
    the segment differ from ``want``."""
    step, views = engine.memory_leaves()
    return step, differing(views, want)


def ckpt_trainer(cfg, optimizer, batch, seed, ckpt_dir, persist_every=0,
                 rec=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = GPT(cfg, device="cuda", generator=gen)
    return Trainer(model, optimizer, token_loss, batch, spec=ParallelSpec(),
                   callbacks=[rec] if rec else [],
                   checkpoint_dir=ckpt_dir, persist_every=persist_every)


def timed_windows(trainer, rec, batch, start, steps, kinds, persist_every):
    """Windows of ``steps`` from step ``start``, one of each kind in turn:
    "without" (no checkpoint), "memory" (a snapshot asked for every step)
    and "disk" (that, and a DISK save every ``persist_every``). For each:
    step ms (wall over steps, to the last step's end on the compute
    stream), the median gap between lag-1 fences, tokens/s, and for the
    checkpointed ones the engine's record of the window's snapshots
    (published, skipped; host ms of a save call; device ms of the copy
    into the device buffer and of the copies to the segment, their span
    and rate; call to publish). Waits for the last snapshot and every
    persist of a window after it, outside its wall time."""
    ckpt = trainer.checkpointer
    engine = ckpt.engine
    out = {k: [] for k in dict.fromkeys(kinds)}
    step = start
    for kind in kinds:
        trainer._ckpt = None if kind == "without" else ckpt
        trainer._persist_every = persist_every if kind == "disk" else 0
        n_log, n_host = len(engine.stage_log), len(engine.stats["host_ms"])
        skipped = engine.stats["skipped"]
        rec.losses, rec.step_s = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.fit(iter([batch] * steps), steps=step + steps,
                    start_step=step)
        # The steps' end, not the last snapshot's: its copy runs on.
        torch.cuda.current_stream().synchronize()
        wall = time.perf_counter() - t0
        step += steps
        tokens = batch.shape[0] * batch.shape[1] * steps
        run = {"step_ms": wall / steps * 1e3, "tokens_per_s": tokens / wall,
               "median_gap_ms": statistics.median(rec.step_s) * 1e3,
               "last_loss": float(rec.losses[-1])}
        if kind != "without":
            engine.wait_staged()
            if kind == "disk":
                last = step - step % persist_every
                check(ckpt.wait_persisted(last, 600),
                      f"step {last} was never persisted")
            log_ = list(engine.stage_log)[n_log:]
            host = engine.stats["host_ms"][n_host:]
            run.update(
                snapshots=len(log_), share=len(log_) / steps,
                skipped=engine.stats["skipped"] - skipped,
                host_ms_median=statistics.median(host) if host else None,
                host_ms_max=max(host) if host else None,
                copy_ms_median=statistics.median(e["copy_ms"] for e in log_),
                d2h_ms_median=statistics.median(e["d2h_ms"] for e in log_),
                d2h_wall_ms_median=statistics.median(
                    e["d2h_wall_ms"] for e in log_),
                d2h_gb_s_median=statistics.median(
                    e["bytes"] / e["d2h_ms"] / 1e6 for e in log_),
                publish_ms_median=statistics.median(
                    e["publish_s"] for e in log_) * 1e3,
                publish_ms_max=max(e["publish_s"] for e in log_) * 1e3,
            )
        out[kind].append(run)
    trainer._ckpt, trainer._persist_every = ckpt, persist_every
    return out, step


def d2h_yardstick(nbytes):
    """GB/s of ATen's copy of ``nbytes`` from the card into pinned memory
    (``copy_`` into a pinned tensor, and ``.to("cpu", non_blocking=True)``,
    which allocates its output), each on the compute stream: the bound
    of the staging's copy to the segment."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, fn in (("copy_into_pinned", lambda: pinned.copy_(
            dev, non_blocking=True)),
                     ("to_cpu_non_blocking", lambda: dev.to(
                         "cpu", non_blocking=True))):
        ms = time_ms(fn, iters=3, warmup=1)
        out[name] = {"ms": ms, "gb_s": nbytes / ms / 1e6}
    del dev, pinned
    return out


def staging_profile(trainer, batch, start, steps=3):
    """Device time a step of the snapshot's copies, from torch.profiler:
    the foreach copy into the device buffer (``multi_tensor_apply``
    kernels of a ``Copy``) and the copies to the segment (``Memcpy
    DtoH``), with the kernels' time a step beside them."""
    torch.cuda.synchronize()
    with device_trace() as prof:
        trainer.fit(iter([batch] * steps), steps=start + steps,
                    start_step=start)
        trainer.checkpointer.engine.wait_staged()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    foreach = [e for e in kernels
               if "multi_tensor_apply" in e.key and "Copy" in e.key]
    dtoh = [e for e in kernels if "Memcpy DtoH" in e.key]
    ms = lambda es: sum(  # noqa: E731
        e.self_device_time_total for e in es) / steps / 1e3
    return {"foreach_copy_ms_per_step": ms(foreach),
            "foreach_copy_launches_per_step": sum(
                e.count for e in foreach) / steps,
            "d2h_ms_per_step": ms(dtoh),
            "kernel_ms_per_step": ms(kernels) - ms(dtoh) - ms(
                [e for e in kernels if "Memcpy" in e.key
                 and "DtoH" not in e.key or "Memset" in e.key])}


def restore_into_fresh(label, cfg, optimizer, batch, seed, ckpt_dir, want,
                       want_step, source):
    """A fresh Trainer (other weights) restores; its every leaf must equal
    ``want`` bit for bit, from ``source``. Returns the trainer and the
    restore's record."""
    fresh = ckpt_trainer(cfg, optimizer, batch, seed, ckpt_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = fresh.restore()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = fresh.checkpointer.engine.last_restore_stats
    bad = differing(state_bytes(fresh), want)
    rec = {"restore_s": wall, "step": step, "source": stats["source"],
           "bytes": stats["bytes"], "register_s": stats["register_s"],
           "read_s": stats["read_s"], "verify_s": stats["verify_s"],
           "scatter_s": stats["scatter_s"],
           "read_gb_s": stats["bytes"] / stats["read_s"] / 1e9
           if stats["read_s"] else None,
           "leaves": len(want), "leaves_differing": len(bad)}
    log(f"[ckpt {label}] restore from {source}: " + json.dumps(rec))
    check(step == want_step and stats["source"] == source,
          f"{label}: restored step {step} from {stats['source']}, want "
          f"{want_step} from {source}")
    check(not bad, f"{label}: restore from {source} differs in {bad[:5]}")
    return fresh, rec


def persist_record(saver):
    stats = saver.last_persist_stats
    check(bool(stats), "the saver recorded no persist")
    s = stats[0]
    return {"bytes": s["bytes"], "persist_s": s["persist_s"],
            "mb_s": s["persist_mbps"], "checksum_s": s["checksum_s"],
            "written_bytes": s["written_bytes"],
            "stripes": s["total_stripes"], "ref_stripes": s["ref_stripes"]}


def ckpt_gpt2(seed, root):
    """Phase (a): GPT-2 124M, AdamW, batch 16 x 1024, the agent's saver in
    this process. Windows without the checkpoint, with a memory snapshot
    every step, and with a DISK save every CKPT_PERSIST steps besides, in
    turns; a persist and its rate; restores from memory, then from disk,
    into fresh Trainers, each held bit for bit to the state at its step;
    one more step from the disk-restored state, whose loss must equal the
    uninterrupted run's."""
    cfg = GPTConfig(**GPT2)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int64)
    ckpt_dir = os.path.join(root, "gpt2-124m")
    rec = Record()
    trainer = ckpt_trainer(cfg, adamw(3e-4), batch, seed, ckpt_dir,
                           CKPT_PERSIST, rec)
    engine = trainer.checkpointer.engine
    check(engine.agent_mode, "124M: the engine did not find the saver")
    trainer.fit(iter([batch] * WARMUP), steps=WARMUP, start_step=0)
    engine.wait_staged()
    check(engine.registered, "124M: the segment is not registered")
    log("[ckpt gpt2-124m] warm-up: " + json.dumps({
        "register_s": engine.stats["register_s"],
        "segment_bytes": engine._shm.size,
        "layout_bytes": engine.stage_log[-1]["bytes"]}))
    reset_counts()
    kinds = ("without", "memory", "disk", "disk", "memory", "without")
    runs, step = timed_windows(trainer, rec, batch, WARMUP, STEPS, kinds,
                               CKPT_PERSIST)
    launches = read_counts()
    saver = AsyncCheckpointSaver.get_ckpt_saver()
    in_loop = persist_record(saver)
    want_counts = flash_want(cfg, STEPS * len(kinds))
    want_counts.update(adam8=0, adam8_fused=0)
    for name, count in launches.items():
        check(count == want_counts[name], f"ckpt 124M: {name} launched "
              f"{count} times, want {want_counts[name]}")
    prof = staging_profile(trainer, batch, step)
    step += 3
    nbytes = engine.stage_log[-1]["bytes"]
    log("[ckpt gpt2-124m] windows: " + json.dumps({
        "runs": runs, "profile": prof, "persist_in_loop": in_loop,
        "yardstick": d2h_yardstick(nbytes), "launches": launches}))
    # Restores: the state at `step` persisted, then read back.
    engine.wait_staged()
    trainer.checkpointer.save_checkpoint(step, trainer.state,
                                         StorageType.DISK)
    check(trainer.checkpointer.wait_persisted(step, 600),
          f"124M: step {step} never persisted")
    persist = persist_record(saver)
    log("[ckpt gpt2-124m] persist of step " + str(step) + ": "
        + json.dumps(persist))
    want = state_bytes(trainer)
    got_step, bad = snapshot_differs(engine, want)
    check(got_step == step and not bad,
          f"124M: snapshot of step {got_step} differs in {bad[:5]}")
    fresh, from_memory = restore_into_fresh(
        "gpt2-124m", cfg, adamw(3e-4), batch, seed + 1, ckpt_dir, want,
        step, "memory")
    fresh.close()
    SharedMemory.remove(engine.shm_name)  # as if the host lost /dev/shm
    fresh, from_disk = restore_into_fresh(
        "gpt2-124m", cfg, adamw(3e-4), batch, seed + 2, ckpt_dir, want,
        step, "storage")
    toks = torch.from_numpy(batch).cuda()
    go_on = float(trainer.train_step(trainer.state, toks)[1]["loss"])
    resumed = float(fresh.train_step(fresh.state, toks)[1]["loss"])
    log(f"[ckpt gpt2-124m] step {step + 1}: uninterrupted loss {go_on!r}, "
        f"from the disk restore {resumed!r}")
    check(resumed == go_on, f"124M: resumed loss {resumed!r} != {go_on!r}")
    fresh.close()
    trainer.close()
    return launches, {"runs": runs, "profile": prof, "persist": persist,
                      "persist_in_loop": in_loop, "memory": from_memory,
                      "disk": from_disk}


def ckpt_xl(seed, root):
    """Phase (b): GPT-2 xl 1.5B, bf16 params, fused adam8bit, batch 4 x
    1024: windows without and with a memory snapshot every step, in
    turns; the race check (a snapshot taken while the next step runs
    equals the state at its step in every leaf); a restore from memory
    into a fresh Trainer, held bit for bit."""
    batch = np.random.default_rng(seed).integers(
        0, XL.vocab_size, (XL_BATCH, SEQ), dtype=np.int64)
    ckpt_dir = os.path.join(root, "gpt2-xl")
    rec = Record()
    trainer = ckpt_trainer(XL_NOREMAT, adam8bit(XL_LR), batch, seed,
                           ckpt_dir, 0, rec)
    engine = trainer.checkpointer.engine
    t0 = time.perf_counter()
    trainer.fit(iter([batch] * WARMUP), steps=WARMUP, start_step=0)
    engine.wait_staged()
    check(engine.registered, "1.5B: the segment is not registered")
    log("[ckpt gpt2-xl] warm-up: " + json.dumps({
        "wall_s": time.perf_counter() - t0,
        "register_s": engine.stats["register_s"],
        "segment_bytes": engine._shm.size,
        "layout_bytes": engine.stage_log[-1]["bytes"]}))
    reset_counts()
    kinds = ("without", "memory", "memory", "without")
    runs, step = timed_windows(trainer, rec, batch, WARMUP, CKPT_XL_STEPS,
                               kinds, 0)
    launches = read_counts()
    want_counts = flash_want(XL_NOREMAT, CKPT_XL_STEPS * len(kinds))
    want_counts.update(adam8=0, adam8_fused=CKPT_XL_STEPS * len(kinds))
    for name, count in launches.items():
        check(count == want_counts[name], f"ckpt 1.5B: {name} launched "
              f"{count} times, want {want_counts[name]}")
    prof = staging_profile(trainer, batch, step)
    step += 3
    # The race: snapshot step `step`, then run the next step at once.
    toks = torch.from_numpy(batch).cuda()
    engine.wait_staged()
    trainer.train_step(trainer.state, toks)
    step += 1
    want = state_bytes(trainer)
    t0 = time.perf_counter()
    check(engine.save_to_memory_async(step, trainer.state),
          "1.5B: the snapshot was skipped")
    in_flight = not engine._staging.done()
    next0 = torch.cuda.Event(enable_timing=True)
    next1 = torch.cuda.Event(enable_timing=True)
    next0.record()
    trainer.train_step(trainer.state, toks)
    next1.record()
    engine.wait_staged()
    publish_s = time.perf_counter() - t0
    d0, d1 = engine.stage_log[-1]["d2h_events"]
    torch.cuda.synchronize()
    # Device ms from the next step's start to the copy's end, and from the
    # copy's start to the next step's end: both > 0 when they overlapped.
    overlap = (next0.elapsed_time(d1), d0.elapsed_time(next1))
    got_step, bad = snapshot_differs(engine, want)
    race = {"step": got_step, "leaves": len(want),
            "leaves_differing": len(bad),
            "in_flight_when_next_step_dispatched": in_flight,
            "next_step_start_to_copy_end_ms": overlap[0],
            "copy_start_to_next_step_end_ms": overlap[1],
            "publish_s": publish_s}
    log("[ckpt gpt2-xl] race check: " + json.dumps(race))
    check(got_step == step and not bad,
          f"1.5B: snapshot of step {got_step} differs in {bad[:5]}")
    check(in_flight and min(overlap) > 0,
          "1.5B: the snapshot's copy did not overlap the next step")
    log("[ckpt gpt2-xl] windows: " + json.dumps({
        "runs": runs, "profile": prof,
        "yardstick": d2h_yardstick(engine.stage_log[-1]["bytes"]),
        "launches": launches}))
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    fresh, from_memory = restore_into_fresh(
        "gpt2-xl", XL_NOREMAT, adam8bit(XL_LR), batch, seed + 1, ckpt_dir,
        want,
        step, "memory")
    fresh.close()
    del fresh, want
    torch.cuda.empty_cache()
    return launches, {"runs": runs, "profile": prof, "race": race,
                      "memory": from_memory}


def crash_child(args):
    """``--crash-child MODE DIR OUT SEED``: GPT-2 124M from SEED, AdamW, a
    memory snapshot asked for every step and no DISK save. ``crash``
    trains until CRASH_AT, writes the step of its last published snapshot
    (CRASH_AT, or before it when that snapshot was skipped) to OUT.ready
    and waits to be killed; ``resume`` restores (from disk) and trains
    RESUMED steps; ``plain`` trains CRASH_AT + RESUMED steps without a
    checkpoint. Each step's loss goes to OUT."""
    mode, ckpt_dir, out, seed = args
    seed = int(seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = GPTConfig(**GPT2)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int64)

    class Losses(TrainerCallback):
        def on_step_end(self, trainer, step, metrics):
            with open(out, "a") as f:
                f.write(f"{step} {float(metrics['loss'])!r} {time.time()!r}\n")
            if mode == "crash" and step == CRASH_AT:
                engine = trainer.checkpointer.engine
                engine.wait_staged()
                with open(out + ".ready", "w") as f:
                    f.write(str(engine.stage_log[-1]["step"]))
                time.sleep(3600)  # killed here

    trainer = ckpt_trainer(cfg, adamw(3e-4), batch, seed,
                           "" if mode == "plain" else ckpt_dir, 0, Losses())
    start = trainer.restore()
    steps = start + RESUMED if mode == "resume" else CRASH_AT + RESUMED
    trainer.fit(iter([batch] * steps), steps=steps, start_step=start)
    trainer.close()
    return 0


def crash_drill(seed, root):
    """Phase (c): a child trains 124M with a memory snapshot asked for
    every step and is SIGKILLed after step CRASH_AT; this process's saver
    flushes the child's last snapshot; a new child resumes from disk at
    that step and takes RESUMED steps, whose losses must equal those of a
    child that was never killed."""
    ckpt_dir = os.path.join(root, "crash")
    procs = []

    def child(mode, out):
        # Its log goes to a file: a pipe nobody drains would fill and
        # stop the child.
        with open(out + ".log", "w") as err:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--crash-child",
                 mode, ckpt_dir, out, str(seed)], stdout=subprocess.DEVNULL,
                stderr=err)
        procs.append(proc)
        return proc

    def tail(out):
        with open(out + ".log") as f:
            return f.read()[-2000:]

    def finish(proc, what, out):
        proc.wait(timeout=600)
        check(proc.returncode == 0,
              f"crash drill: {what} child failed: {tail(out)}")

    def losses(out):
        rows = [line.split() for line in open(out).read().splitlines()]
        return {int(s): (loss, float(t)) for s, loss, t in rows}

    outs = {m: os.path.join(root, f"{m}.txt")
            for m in ("plain", "crash", "resume")}
    try:
        finish(child("plain", outs["plain"]), "plain", outs["plain"])
        proc = child("crash", outs["crash"])
        deadline = time.monotonic() + 600
        while not os.path.exists(outs["crash"] + ".ready"):
            check(proc.poll() is None,
                  "crash drill: the child died: " + tail(outs["crash"]))
            check(time.monotonic() < deadline, "crash drill: no step 4")
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        t_kill = time.time()
        proc.wait(timeout=60)
        with open(outs["crash"] + ".ready") as f:
            snapshot = int(f.read())
        saver = AsyncCheckpointSaver.get_ckpt_saver()
        check(saver is not None, "crash drill: the child never registered")
        saver.save_shm_to_storage()
        flush_s = time.time() - t_kill
        tracker = ckpt_persist.read_tracker(saver.storage, ckpt_dir)
        check(tracker == snapshot and CRASH_AT - 1 <= snapshot <= CRASH_AT,
              f"crash drill: the flush committed step {tracker}; the "
              f"child's last snapshot was of step {snapshot}")
        flushed = persist_record(saver)
        AsyncCheckpointSaver.stop()  # the resumed child restores from disk
        finish(child("resume", outs["resume"]), "resume", outs["resume"])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    plain, resumed = losses(outs["plain"]), losses(outs["resume"])
    first = min(resumed)
    drill = {"killed_after_step": CRASH_AT, "last_snapshot": snapshot,
             "flush_s": flush_s,
             "flush": flushed,
             "kill_to_first_resumed_step_s": resumed[first][1] - t_kill,
             "resumed_losses": {s: v[0] for s, v in resumed.items()},
             "uninterrupted_losses": {s: v[0] for s, v in plain.items()}}
    log("[ckpt crash] " + json.dumps(drill))
    check(sorted(resumed) == list(range(snapshot + 1,
                                        snapshot + RESUMED + 1)),
          f"crash drill: resumed steps {sorted(resumed)}")
    check(all(resumed[s][0] == plain[s][0] for s in resumed),
          "crash drill: the resumed losses differ from the uninterrupted")
    return drill


# ------------------------------------------------------- the mesh branches

# Each branch's window on its one-rank mesh, after WARMUP steps; then
# TRACED traced steps (profile_window), as on the one-device path beside
# it.
MESH_STEPS = 4
# The windows of the two-axis mesh, ZeRO-1 beside it and the plain
# module (each after WARMUP steps, at most TRACED traced).
TWO_AXIS_STEPS = 2
# The causal kernel of [registry]'s conv.
CONV_K = 4


class MeshLoop:
    """``res.train_step`` on one batch already on the card, with the
    surface ``profile_window`` drives (``state``, ``fit``); the losses
    stay on the card until read."""

    def __init__(self, res, batch):
        self.res, self.state = res, res.state
        self.batch = torch.from_numpy(res.local_batch(batch)).cuda()
        self.losses = []

    def fit(self, batches, steps):
        for _ in batches:
            _, metrics = self.res.train_step(self.state, self.batch)
            self.losses.append(metrics["loss"])
        return {"step": self.state["step"]}


def mesh_window(label, res, batch, cfg, base, traced=TRACED,
                steps=MESH_STEPS,
                fused=True, unfused=False):
    """WARMUP steps, a timed window of ``steps`` (each flash kernel of the
    model's head_dim once a layer a step, the forward twice under remat,
    the fused 8-bit Adam once a step, or never without ``fused``, the
    unfused one once a step with ``unfused``, else never), then
    ``traced`` steps (none: no trace). The peak is the window's above
    ``base`` (the bytes allocated before the branch was built: the
    reference kept beside it)."""
    loop = MeshLoop(res, batch)
    loop.fit(range(WARMUP), WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop.losses = []
    reset_counts()
    t0 = time.perf_counter()
    loop.fit(range(steps), steps)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    launches = read_counts()
    losses = [float(x) for x in loop.losses]
    want = flash_want(cfg, steps)
    want.update(adam8=steps if unfused else 0,
                adam8_fused=steps if fused else 0)
    for name, count in launches.items():
        check(count == want[name],
              f"{label}: {name} launched {count} times, want {want[name]}")
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    stats = {"step_ms": window_s / steps * 1e3,
             "peak_mem_gib": (torch.cuda.max_memory_allocated() - base)
             / 2**30, "losses": losses, "launches": launches}
    if traced:
        prof = profile_window(label, loop, batch, stats["step_ms"],
                              steps=traced)
        stats["busy_share"] = prof["kernel_busy_share"]
        stats["kernel_ms"] = prof["kernel_ms_per_step"]
    log(f"[mesh {label}] " + json.dumps(stats))
    return stats, loop


@contextlib.contextmanager
def world_of_one(tag):
    """An NCCL process group of one rank to be (``create_mesh`` joins it
    from MASTER_ADDR/PORT, RANK and WORLD_SIZE, set here), a job name and
    a checkpoint directory under build/ of its own: ``(device, root)``.
    Afterwards the group is destroyed and the variables, the job's
    shared-memory segments and the directory removed."""
    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    launch = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                  WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(launch)
    root = os.path.join("build", f"{tag}-ckpt-{os.getpid()}")
    job = f"{tag}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
    os.environ["DLROVER_TPU_JOB_NAME"] = job
    try:
        yield torch.device("cuda", 0), root
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for name in launch:
            os.environ.pop(name, None)
        unlink_segments(job)
        shutil.rmtree(root, ignore_errors=True)


def mesh_phases(seed, windows):
    """Each axis's branch of ``accelerate_on_mesh`` on an NCCL world of
    one rank, on a mesh that has the axis (size 1): GPT-2 xl (remat
    "dots", adam8bit, 4 x 1024) under fsdp, then data, and the LLaMA
    preset (4 x 2048) under tensor, each beside the one-device path of
    the same seed and batch. Each window's losses equal the one-device
    path's bit for bit (so do fsdp's parameters); the kernels launch as
    often; a sharded snapshot of the fsdp run, persisted, restores into
    a fresh one-device trainer bit for bit, leaf by leaf. Records each
    window's step ms, peak GiB and busy share beside the one-device
    path's."""
    with world_of_one("mesh") as (dev, root):
        return _mesh_phases(seed, windows, dev, root)


def _mesh_phases(seed, windows, dev, root):
    import torch.distributed as dist

    summary = {}

    def model(cfg, model_cls, s):
        gen = torch.Generator(device="cuda").manual_seed(s)
        return model_cls(cfg, device="cuda", generator=gen)

    def branch(label, cfg, model_cls, lr, batch, axes, steps=MESH_STEPS,
               traced=TRACED):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        if not axes:
            res = auto_accelerate(model(cfg, model_cls, seed), adam8bit(lr),
                                  batch, token_loss, spec=ParallelSpec(),
                                  device=dev)
        else:
            mesh = create_mesh([(a, 1) for a in axes], dev)
            check(dist.get_backend() == "nccl", "the mesh is not on NCCL")
            res = accelerate_on_mesh(model(cfg, model_cls, seed),
                                     adam8bit(lr), batch, token_loss, mesh,
                                     device=dev)
            check(res.mesh is mesh, f"{label}: not on the mesh")
        name = f"{label} {' x '.join(axes) or 'one device'}"
        stats, loop = mesh_window(name, res, batch, cfg, base, steps=steps,
                                  traced=traced)
        windows[f"mesh {name}"] = stats["launches"]
        summary[name] = {k: stats[k] for k in ("step_ms", "peak_mem_gib",
                                                "busy_share", "kernel_ms")
                         if k in stats}
        return stats, res

    batch = np.random.default_rng(seed).integers(
        0, XL.vocab_size, (XL_BATCH, SEQ), dtype=np.int64)
    # (GPT-2 xl's windows are not traced, so each branch stops at the
    # same step: the script's time went to the offload window.)
    one, one_res = branch("gpt2-xl", XL, GPT, XL_LR, batch, (), traced=0)
    xl_one = one["losses"]
    got, res = branch("gpt2-xl", XL, GPT, XL_LR, batch, ("fsdp",),
                      traced=0)
    check(got["losses"] == one["losses"],
          f"fsdp losses {got['losses']} differ from one device's "
          f"{one['losses']}")
    bad = [n for n, p in res.state["params"].items()
           if not torch.equal(sharding.local(p),
                              one_res.state["params"][n])]
    check(not bad, f"fsdp parameters differ from one device's: {bad}")
    # The fsdp run's sharded snapshot, persisted, into a fresh
    # one-device trainer of another seed.
    step = res.state["step"]
    ck = ShardedCheckpointer(root, mesh_axes={"fsdp": 1})
    check(ck.save_checkpoint(step, res.state, StorageType.DISK),
          "fsdp: the sharded save failed")
    ck.close()
    del res
    torch.cuda.empty_cache()
    fresh = auto_accelerate(model(XL, GPT, seed + 1), adam8bit(XL_LR),
                            batch, token_loss, spec=ParallelSpec(),
                            device=dev)
    ck = FlashCheckpointer(root)
    restored = ck.load_checkpoint(fresh.state)[0]
    ck.close()
    check(restored == step, f"restored step {restored}, want {step}")
    bad = differing(state_bytes(fresh), state_bytes(one_res))
    check(not bad, f"the fsdp snapshot restored with leaves {bad} "
          "differing")
    log(f"[mesh gpt2-xl] fsdp snapshot of step {step}: every leaf "
        "restored bit for bit on one device")
    del fresh
    torch.cuda.empty_cache()
    mesh_offload(seed, windows, dev, batch, got, summary)
    got, res = branch("gpt2-xl", XL, GPT, XL_LR, batch, ("data",),
                      traced=0)
    check(got["losses"] == one["losses"],
          f"data losses {got['losses']} differ from one device's "
          f"{one['losses']}")
    del one_res, res
    torch.cuda.empty_cache()
    b, seq = LLAMA_RUNS[0][:2]
    cfg = LlamaConfig.preset(seq)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, seq), dtype=np.int64)
    one, res = branch(f"llama B{b} S{seq}", cfg, Llama, LLAMA_LR, batch,
                      ())
    del res
    torch.cuda.empty_cache()
    got, res = branch(f"llama B{b} S{seq}", cfg, Llama, LLAMA_LR, batch,
                      ("tensor",))
    check(got["losses"] == one["losses"],
          f"tensor losses {got['losses']} differ from one device's "
          f"{one['losses']}")
    del res
    torch.cuda.empty_cache()
    # fsdp x tensor: FSDP2 over the tensor-parallel DTensors; the
    # embedding's rows on the tensor axis, looked up vocab-parallel.
    got, res = branch(f"llama B{b} S{seq}", cfg, Llama, LLAMA_LR, batch,
                      ("fsdp", "tensor"), steps=TWO_AXIS_STEPS)
    check(got["losses"] == one["losses"][:TWO_AXIS_STEPS],
          f"fsdp x tensor losses {got['losses']} differ from one device's "
          f"{one['losses'][:TWO_AXIS_STEPS]}")
    lay = sharding.layout_of(res.state["params"]["embed.weight"])
    check(res.module.vocab_mesh is not None
          and lay.shard[lay.mesh.mesh_dim_names.index("tensor")] == 0,
          "fsdp x tensor: the embedding is not vocab-parallel")
    del res
    torch.cuda.empty_cache()
    registry_window(seed, windows, summary, dev)
    log("[mesh] " + json.dumps(summary))
    return xl_one


def mesh_offload(seed, windows, dev, batch, fsdp, summary):
    """``[offload]``: GPT-2 xl ("dots", ``adam8bit``) on ("fsdp", 1) with
    ``offload_optimizer=True``: WARMUP steps and a window of
    ``TWO_AXIS_STEPS``, the 8-bit moments ``MeshOptimizer`` keeps whole
    in pinned host memory between steps; the losses bit for bit the
    ("fsdp", 1) window's first ones (``fsdp``: its stats), the peak below
    its, the GB each way a step and the copies' GB/s, step ms."""
    from dlrover_tpu_torch.accel.accelerate import MeshOptimizer
    from dlrover_tpu_torch.optim.offload import OffloadOptimizer

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res = accelerate_on_mesh(GPT(XL, device="cuda", generator=gen),
                             adam8bit(XL_LR), batch, token_loss,
                             create_mesh([("fsdp", 1)], dev), device=dev,
                             offload_optimizer=True)
    opt = res.state["opt"]
    check(isinstance(opt, OffloadOptimizer)
          and isinstance(opt.inner, MeshOptimizer),
          f"offload on fsdp: the optimizer is a {type(opt).__name__}")
    check(bool(opt.moved) and all(t.device.type == "cpu" and t.is_pinned()
                                  for t in opt.moved),
          "offload on fsdp: a moved leaf is not in pinned host memory")
    opt.take_copy_stats()
    stats = mesh_window("gpt2-xl fsdp offload", res, batch, XL, base,
                        traced=0, steps=TWO_AXIS_STEPS)[0]
    windows["mesh gpt2-xl fsdp offload"] = stats["launches"]
    copies = opt.take_copy_stats()
    steps = WARMUP + TWO_AXIS_STEPS
    check(stats["losses"] == fsdp["losses"][:TWO_AXIS_STEPS],
          f"offload on fsdp: losses {stats['losses']} differ from the "
          f"fsdp window's {fsdp['losses'][:TWO_AXIS_STEPS]}")
    check(stats["peak_mem_gib"] < fsdp["peak_mem_gib"],
          f"offload on fsdp: peak {stats['peak_mem_gib']:.2f} GiB not below "
          f"the fsdp window's {fsdp['peak_mem_gib']:.2f}")
    out = {"step_ms": stats["step_ms"], "fsdp_step_ms": fsdp["step_ms"],
           "peak_mem_gib": stats["peak_mem_gib"],
           "fsdp_peak_mem_gib": fsdp["peak_mem_gib"],
           "state_gb": opt.nbytes / 1e9}
    for way in ("in", "out"):
        out[f"{way}_gb_a_step"] = copies[f"{way}_bytes"] / steps / 1e9
        out[f"{way}_gb_s"] = (copies[f"{way}_bytes"] / 1e9
                              / (copies[f"{way}_ms"] / 1e3)
                              if copies[f"{way}_ms"] else None)
    summary["gpt2-xl fsdp offload"] = out
    log("[offload] " + json.dumps(out))
    del res, opt
    torch.cuda.empty_cache()


class PlainBlock(nn.Module):
    """A pre-LN block of plain torch modules (no ``logical_axes()``):
    q, k, v, o and a GELU MLP (up, down) as ``nn.Linear``, two
    ``nn.LayerNorm``; its attention the port's flash kernels over the
    heads of the local width (``view(b, s, -1, head_dim)``)."""

    def __init__(self, d, head_dim, dtype):
        super().__init__()
        kw = dict(device="cuda", dtype=dtype)
        self.head_dim = head_dim
        self.ln1 = nn.LayerNorm(d, **kw)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.o_proj = nn.Linear(d, d, **kw)
        self.ln2 = nn.LayerNorm(d, **kw)
        self.up = nn.Linear(d, 4 * d, **kw)
        self.down = nn.Linear(4 * d, d, **kw)

    def forward(self, x):
        from dlrover_tpu_torch.ops.attention import flash_attention

        b, s, _ = x.shape
        y = self.ln1(x)
        q, k, v = (proj(y).view(b, s, -1, self.head_dim)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        x = x + self.o_proj(flash_attention(q, k, v, causal=True)
                            .reshape(b, s, -1))
        y = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        return x + self.down(y)


class PlainGPT(nn.Module):
    """GPT-2 124M's widths as a plain module, bf16: token and position
    ``nn.Embedding``s, ``block_<i>``, a final ``nn.LayerNorm`` and an
    untied ``nn.Linear`` head; torch's default init from the global
    seed."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device="cuda", dtype=dtype)
        self.layers = cfg.num_layers
        self.wte = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.d_model, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", PlainBlock(cfg.d_model,
                                                     cfg.head_dim, dtype))
        self.ln_f = nn.LayerNorm(cfg.d_model, **kw)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                 **kw)

    def forward(self, tokens):
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.wte(tokens) + self.wpe(pos)
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        return self.lm_head(self.ln_f(x))


class ConvMix(nn.Module):
    """A causal conv over the sequence (kernel ``CONV_K``, left-padded)
    and a bare per-channel ``gain``, residual: ``x + conv(x) * gain``."""

    def __init__(self, d, dtype):
        super().__init__()
        self.conv = nn.Conv1d(d, d, CONV_K, device="cuda", dtype=dtype)
        self.gain = nn.Parameter(torch.full((d,), 0.5, device="cuda",
                                            dtype=dtype))

    def forward(self, x):
        y = self.conv(F.pad(x.transpose(1, 2), (CONV_K - 1, 0)))
        return x + y.transpose(1, 2) * self.gain


class ConvPlainGPT(PlainGPT):
    """``PlainGPT`` with a ``ConvMix`` after the embeddings: a conv weight
    and a bare parameter that a registry puts on the tensor axis."""

    def __init__(self, cfg, dtype=torch.bfloat16):
        super().__init__(cfg, dtype)
        self.mix = ConvMix(cfg.d_model, dtype)

    def forward(self, tokens):
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.mix(self.wte(tokens) + self.wpe(pos))
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x)
        return self.lm_head(self.ln_f(x))


def conv_registry():
    """The conv's out channels, its bias and ``gain`` on ``mlp`` (the
    tensor axis); the defaults elsewhere (the embeddings' vocab rows on
    tensor too)."""
    from dlrover_tpu_torch.accel.registry import ShardingRegistry

    return (ShardingRegistry()
            .register(r"mix\.conv\.weight$", ("mlp", None, None))
            .register(r"mix\.conv\.bias$", ("mlp",))
            .register(r"mix\.gain$", ("mlp",)))


def plain_loss(module, params, batch):
    """Next-token cross entropy of the whole logits, in fp32."""
    logits = module(batch)[:, :-1].float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch[:, 1:, None])[..., 0]
    return torch.mean(lse - tgt)


def registry_window(seed, windows, summary, dev):
    """``[registry]``: ``PlainGPT`` (GPT-2 124M's widths, 16 x 1024,
    ``adamw``) on one device, then placed on an ("fsdp", 1), ("tensor",
    1) mesh by ``plan_tp``'s registry: the planner's roles (q/k/v/up
    column-, o/down row-parallel, the head column-parallel over the
    vocab), the embeddings vocab-parallel, each window's losses bit for
    bit the one device's and the head_dim-64 flash kernels as often."""
    cfg = GPTConfig(**GPT2)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int64)

    def plain():
        torch.manual_seed(seed)
        return PlainGPT(cfg)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    one = auto_accelerate(plain(), adamw(3e-4), batch, plain_loss,
                          spec=ParallelSpec(), device=dev)
    label = "plain gpt2-124m"
    stats = mesh_window(f"{label} one device", one, batch, cfg, base,
                        steps=TWO_AXIS_STEPS, fused=False)[0]
    windows[f"registry {label} one device"] = stats["launches"]
    summary[f"{label} one device"] = {
        k: stats[k] for k in ("step_ms", "peak_mem_gib", "busy_share",
                              "kernel_ms")}
    want = stats["losses"]
    del one
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    mesh = create_mesh([("fsdp", 1), ("tensor", 1)], dev)
    res = accelerate_on_mesh(plain(), adamw(3e-4), batch, plain_loss, mesh,
                             device=dev, allow_tensor=True)
    roles = {n: m.role for n, m in res.module.named_modules()
             if isinstance(m, ParallelLinear)}
    expect = {"lm_head": "col"}
    for i in range(cfg.num_layers):
        for proj, role in (("q_proj", "col"), ("k_proj", "col"),
                           ("v_proj", "col"), ("up", "col"),
                           ("o_proj", "row"), ("down", "row")):
            expect[f"block_{i}.{proj}"] = role
    check(roles == expect, f"registry: the planner's roles {roles}, want "
          f"{expect}")
    check(isinstance(res.module.wte, VocabParallelEmbedding),
          "registry: the token embedding is not vocab-parallel")
    stats = mesh_window(f"{label} fsdp x tensor", res, batch, cfg, base,
                        steps=TWO_AXIS_STEPS, fused=False)[0]
    windows[f"registry {label} fsdp x tensor"] = stats["launches"]
    check(stats["losses"] == want, f"registry losses {stats['losses']} "
          f"differ from one device's {want}")
    summary[f"{label} fsdp x tensor"] = {
        k: stats[k] for k in ("step_ms", "peak_mem_gib", "busy_share",
                              "kernel_ms")}
    log("[registry] " + json.dumps({
        "roles": {k: roles[k] for k in sorted(roles)
                  if k.startswith(("block_0.", "lm_head"))},
        "planned": len(roles), "losses": stats["losses"],
        "one_device_losses": want}))
    del res
    torch.cuda.empty_cache()
    registry_conv_window(seed, windows, summary, dev, cfg, batch)


def registry_conv_window(seed, windows, summary, dev, cfg, batch):
    """``[registry]``'s conv: ``ConvPlainGPT`` (AdamW, 16 x 1024) on one
    device, then on a ("tensor", 1) mesh placed by ``conv_registry``:
    the conv's weight, its bias and ``gain`` stored as tensor shards
    (DTensors) and gathered whole before the conv's forward
    (``gather_in_forward``); the losses bit for bit the one device's,
    the D-64 flash kernels as many. cuDNN runs deterministic
    algorithms meanwhile (its weight-gradient kernels may otherwise add
    in another order each run)."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _registry_conv(seed, windows, summary, dev, cfg, batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _registry_conv(seed, windows, summary, dev, cfg, batch):
    from torch.distributed.tensor import DTensor

    def plain():
        torch.manual_seed(seed)
        return ConvPlainGPT(cfg)

    label = "plain gpt2-124m conv"
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    one = auto_accelerate(plain(), adamw(3e-4), batch, plain_loss,
                          spec=ParallelSpec(), device=dev)
    stats = mesh_window(f"{label} one device", one, batch, cfg, base,
                        traced=0, steps=TWO_AXIS_STEPS, fused=False)[0]
    windows[f"registry {label} one device"] = stats["launches"]
    want = stats["losses"]
    del one
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    res = accelerate_on_mesh(plain(), adamw(3e-4), batch, plain_loss,
                             create_mesh([("tensor", 1)], dev), device=dev,
                             registry=conv_registry())
    sharded = sorted(n for n, p in res.state["params"].items()
                     if n.startswith("mix.") and isinstance(p, DTensor))
    check(sharded == ["mix.conv.bias", "mix.conv.weight", "mix.gain"],
          f"registry conv: the tensor shards are {sharded}")
    stats = mesh_window(f"{label} tensor", res, batch, cfg, base,
                        traced=0, steps=TWO_AXIS_STEPS, fused=False)[0]
    windows[f"registry {label} tensor"] = stats["launches"]
    check(stats["losses"] == want, f"registry conv losses "
          f"{stats['losses']} differ from one device's {want}")
    summary[f"{label} tensor"] = {k: stats[k] for k in ("step_ms",
                                                       "peak_mem_gib")}
    log("[registry conv] " + json.dumps({
        "sharded": sharded, "losses": stats["losses"],
        "one_device_losses": want, "step_ms": stats["step_ms"]}))
    del res
    torch.cuda.empty_cache()


# ------------------------------------------------------- experts, sequence

MOE_PARTS = ("routing", "dispatch", "experts", "combine")


def moe_split(prof, steps):
    """Device ms a step of each part of the MoE layers (``ops/moe.py``'s
    profiler ranges "moe/<part>"): the kernels of the ops run inside the
    range (the forward, and remat's recompute) and of the backward nodes
    those ops made (matched by autograd's sequence number), without a
    recompute nested in a backward node (it has its own ranges)."""
    cpu = torch.autograd.DeviceType.CPU
    part_of, us = {}, dict.fromkeys(MOE_PARTS, 0.0)

    def kernels(e):
        return sum(k.duration for k in e.kernels) + sum(
            kernels(c) for c in e.cpu_children)

    def mark(e, part):
        if e.sequence_nr >= 0:
            part_of[e.sequence_nr] = part
        for c in e.cpu_children:
            mark(c, part)

    def backward_kernels(e):
        return sum(k.duration for k in e.kernels) + sum(
            backward_kernels(c) for c in e.cpu_children
            if c.sequence_nr < 0 and not c.name.startswith("moe/"))

    events = [e for e in prof.events() if e.device_type == cpu]
    for e in events:
        if e.name.startswith("moe/"):
            us[e.name[4:]] += kernels(e)
            mark(e, e.name[4:])
    for e in events:
        if e.name.startswith("autograd::engine::evaluate_function") and \
                e.sequence_nr in part_of:
            node = e.cpu_children[0] if e.cpu_children else e
            us[part_of[e.sequence_nr]] += sum(
                k.duration for k in e.kernels) + backward_kernels(node)
    ms = {p: t / steps / 1e3 for p, t in us.items()}
    return {"moe_ms_per_step": {
        "routing": ms["routing"],
        "dispatch_combine": ms["dispatch"] + ms["combine"],
        "expert_products": ms["experts"]}}


def check_moe_leaves(opt, cfg):
    """The 8-bit Adam's state covers every expert stack whole: a leaf
    ``layers/moe/<w>`` of [L, E, d, f] values for each matrix."""
    want = cfg.num_layers * cfg.num_experts * cfg.d_model * cfg.ff_dim
    mats = ("w_up", "w_gate", "w_down")
    have = {w: opt.state.m[f"layers/moe/{w}"].q.numel() for w in mats}
    check(all(n >= want for n in have.values()),
          f"8-bit Adam moments of the expert stacks {have}, want {want}")
    return have


def moe_train(seed, windows):
    """(a) The LLaMA-MoE at full width through ``Trainer.fit``: 2 warm-up
    steps, a window of MOE_STEPS (each head_dim-128 flash kernel 22
    times a step, the forward 44; the fused 8-bit Adam once a step over
    every leaf, the expert stacks too; the loss finite and falling),
    TRACED traced steps (busy share, the MoE's device time by part)."""
    label = f"llama-moe B{MOE_BATCH} S{MOE.max_seq_len}"
    launches, trainer, batch, stats = train(
        label, MOE, adam8bit(LLAMA_LR), MOE_BATCH, MOE_STEPS, seed,
        model_cls=Llama, seq=MOE.max_seq_len, loss=moe_token_loss)
    windows[label] = launches
    stats["moe_leaves"] = check_moe_leaves(trainer.state["opt"], MOE)
    stats["active_params"] = MOE.param_count(active=True)
    prof = profile_window(label, trainer, batch, stats["step_ms"],
                          steps=TRACED, extra=moe_split)
    split = prof["moe_ms_per_step"]
    summary = {k: stats[k] for k in ("step_ms", "tokens_per_s", "mfu",
                                     "peak_mem_gib", "params",
                                     "active_params", "flops_per_token")}
    summary.update(busy_share=prof["kernel_busy_share"],
                   kernel_ms=prof["kernel_ms_per_step"], moe_ms=split,
                   moe_share=sum(split.values())
                   / prof["kernel_ms_per_step"])
    log(f"[moe {label}] " + json.dumps(summary))
    del trainer
    torch.cuda.empty_cache()
    return stats, launches, batch


def moe_on_expert_axis(seed, windows, want_losses, want_launches, batch):
    """(b) The same model, seed and batch on a mesh with an expert axis of
    size 1 (the NCCL world of one): its window's losses equal (a)'s bit
    for bit with as many launches; its sharded snapshot, persisted,
    restores into a fresh one-device trainer bit for bit."""
    import torch.distributed as dist

    label = "llama-moe expert"
    with world_of_one("moe") as (dev, root):
        mesh = create_mesh([("expert", 1)], dev)
        check(dist.get_backend() == "nccl", "the mesh is not on NCCL")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        res = accelerate_on_mesh(
            Llama(MOE, device="cuda", generator=gen), adam8bit(LLAMA_LR),
            batch, moe_token_loss, mesh, device=dev)
        stats = mesh_window(label, res, batch, MOE, 0)[0]
        windows[label] = stats["launches"]
        check(stats["losses"] == want_losses,
              f"expert-axis losses {stats['losses']} differ from one "
              f"device's {want_losses}")
        check(stats["launches"] == want_launches,
              f"expert-axis launches {stats['launches']}, one device "
              f"{want_launches}")
        step = res.state["step"]
        ck = ShardedCheckpointer(root, mesh_axes={"expert": 1})
        check(ck.save_checkpoint(step, res.state, StorageType.DISK),
              "expert: the sharded save failed")
        ck.close()
        # The fresh trainer restores the disk copy: the segment's 28 GB of
        # host memory go now. The state to hold it to stays on the card
        # (the host's 96 GiB would not take two copies beside the file's).
        unlink_segments(os.environ["DLROVER_TPU_JOB_NAME"])
        want = state_bytes(res)
        del res
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        fresh = auto_accelerate(
            Llama(MOE, device="cuda", generator=gen), adam8bit(LLAMA_LR),
            batch, moe_token_loss, spec=ParallelSpec(), device=dev)
        ck = FlashCheckpointer(root)
        restored = ck.load_checkpoint(fresh.state)[0]
        ck.close()
        check(restored == step, f"restored step {restored}, want {step}")
        leaves = train_state_leaves(fresh.state)
        bad = sorted(set(want) ^ {leaf.path for leaf in leaves}) + [
            leaf.path for leaf in leaves if leaf.path in want
            and not torch.equal(leaf_bytes(leaf).to("cuda"),
                                want[leaf.path])]
        check(not bad, f"the expert snapshot restored with leaves {bad} "
              "differing")
        log(f"[moe {label}] snapshot of step {step} ({len(want)} leaves, "
            f"{sum(t.numel() for t in want.values()) / 1e9:.2f} GB): every "
            "leaf restored bit for bit on one device; window "
            + json.dumps({k: stats[k] for k in ("step_ms", "peak_mem_gib",
                                                "busy_share", "kernel_ms")}))
        del fresh, leaves, want
        torch.cuda.empty_cache()
        seq_bodies(seed, windows, create_mesh([("seq", 1)], dev))


def seq_bodies(seed, windows, mesh):
    """(c) ``ring_attention_shard`` and ``ulysses_attention_shard(inner=
    "pallas")`` on the NCCL group of one at the preset's attention shape
    (bf16, causal), forward and backward, each held to the plain
    attention (fp32) under ``attn.tile_rel_err`` / ``TILE_REL_TOL``;
    Ulysses launches each head_dim-128 flash kernel once; each timed
    beside the flash kernels' forward and backward alone."""
    from dlrover_tpu_torch.ops.ring_attention import ring_attention_shard
    from dlrover_tpu_torch.ops.ulysses import ulysses_attention_shard

    group = mesh.get_group("seq")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = qkv_do(gen, *SEQ_SHAPE[:2], *SEQ_SHAPE[2:])
    leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    ref = attn.reference_attention(*leaves, causal=True)
    ref.backward(do.float())
    want = [ref.detach()] + [x.grad for x in leaves]
    del ref, leaves
    bodies = {
        "ring": lambda a, b, c: ring_attention_shard(a, b, c, True, group),
        "ulysses": lambda a, b, c: ulysses_attention_shard(
            a, b, c, True, group, inner="pallas"),
        "flash": lambda a, b, c: attn.flash_attention(a, b, c, True),
    }
    out = {}
    for name, body in bodies.items():
        ins = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

        def step():
            o = body(*ins)
            o.backward(do)
            return o

        reset_counts()
        o = step()
        torch.cuda.synchronize()
        launches = read_counts()
        errs = {n: attn.tile_rel_err(g, w) for n, g, w in zip(
            ("o", "dq", "dk", "dv"), [o] + [x.grad for x in ins], want)}
        check(all(math.isfinite(e) and e <= attn.TILE_REL_TOL
                  for e in errs.values()),
              f"{name}: tile errors {errs} over {attn.TILE_REL_TOL}")
        if name == "ulysses":
            windows["seq ulysses"] = launches
            for kern in FLASH128:
                check(launches[kern] == 1,
                      f"ulysses: {kern} launched {launches[kern]} times")
        del o
        out[name] = {"tile_rel_err": errs, "launches": {
            k_: c for k_, c in launches.items() if c},
            "fwd_bwd_ms": time_ms(step, SEQ_ITERS, 1)}
        del ins
        torch.cuda.empty_cache()
    log(f"[seq B{SEQ_SHAPE[0]} S{SEQ_SHAPE[1]} H{SEQ_SHAPE[2]} "
        f"D{SEQ_SHAPE[3]}] " + json.dumps(out)
        + f" (limit: tile_rel_err <= {attn.TILE_REL_TOL})")


# ------------------------------------------------------- ZeRO-1, the search


class PortLog:
    """The messages the port's logger emits (it does not propagate)."""

    def __enter__(self):
        self.messages = []
        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = lambda r: self.messages.append(r.getMessage())
        port_logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        port_logger.removeHandler(self.handler)


def zero_state_gib(opt):
    """GiB of a ZeroOptimizer's state (its inner optimizer's, over the
    slices: masters and moments) and of its slice and gradient buffers."""
    inner = opt.inner
    tensors = list(getattr(inner, "master", {}).values())
    torch_opt = getattr(inner, "inner", inner)
    tensors += [t for st in torch_opt.state.values() for t in st.values()
                if torch.is_tensor(t)]
    state = sum(t.numel() * t.element_size() for t in tensors) / 2**30
    buffers = sum(t.numel() * t.element_size() for t in
                  list(opt._send.values()) + list(opt._grads.values()))
    return state, buffers / 2**30


def zero_phases(seed, windows, xl_one):
    """ZeRO-1 on an NCCL world of one with a ("data", 1) mesh: (a) the
    LLaMA preset at 4 x 2048 ("dots", the flash kernels) under
    ``bf16_master_weights(adamw)`` with ``zero=True`` (the wrapper owns
    whole leaves and all-gathers them) beside the one-device run of the
    same seed and batch: each window's losses bit for bit, the
    head_dim-128 kernels 22 / 44 times a step; the sliced state's GiB and
    step ms; its snapshot persisted (stamped with degree 0) and restored
    into a fresh one-device trainer bit for bit. (b) GPT-2 xl ("dots")
    under ``adam8bit`` with ``zero=True``: JAX's warning (nothing to
    slice), the fused 8-bit Adam once a step over every leaf, and the
    losses of ``xl_one`` (the one-device run of the mesh phases) bit for
    bit."""
    import torch.distributed as dist

    from dlrover_tpu_torch.accel.zero import ZeroOptimizer, zero_degree_of

    b, seq = LLAMA_RUNS[0][:2]
    cfg = LlamaConfig.preset(seq)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, seq), dtype=np.int64)
    summary = {}

    def llama(s):
        gen = torch.Generator(device="cuda").manual_seed(s)
        return Llama(cfg, device="cuda", generator=gen)

    with world_of_one("zero") as (dev, root):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        one = auto_accelerate(llama(seed),
                              bf16_master_weights(adamw(LLAMA_LR)), batch,
                              token_loss, spec=ParallelSpec(), device=dev)
        label = f"llama B{b} S{seq} bf16 adamw"
        stats = mesh_window(f"{label} one device", one, batch, cfg, base,
                            traced=0, steps=TWO_AXIS_STEPS, fused=False)[0]
        windows[f"zero {label} one device"] = stats["launches"]
        summary["one device"] = {k: stats[k] for k in ("step_ms",
                                                       "peak_mem_gib")}
        want = stats["losses"]
        del one
        torch.cuda.empty_cache()
        mesh = create_mesh([("data", 1)], dev)
        check(dist.get_backend() == "nccl", "the mesh is not on NCCL")
        res = accelerate_on_mesh(llama(seed),
                                 bf16_master_weights(adamw(LLAMA_LR)), batch,
                                 token_loss, mesh, device=dev, zero=True)
        opt = res.state["opt"]
        check(isinstance(opt, ZeroOptimizer) and res.spec.zero,
              f"zero: the optimizer is a {type(opt).__name__}")
        check(set(opt.slices) == set(res.state["params"]),
              "zero: a leaf was not sliced on a data axis of one")
        stats = mesh_window(f"{label} zero", res, batch, cfg, base,
                            traced=0, steps=TWO_AXIS_STEPS, fused=False)[0]
        windows[f"zero {label}"] = stats["launches"]
        check(stats["losses"] == want, f"zero losses {stats['losses']} "
              f"differ from one device's {want}")
        state_gib, buffers_gib = zero_state_gib(opt)
        summary["zero"] = {**{k: stats[k] for k in ("step_ms",
                                                    "peak_mem_gib")},
                           "sliced_state_gib": state_gib,
                           "slice_buffers_gib": buffers_gib,
                           "step_over_one_device": stats["step_ms"]
                           / summary["one device"]["step_ms"]}
        step = res.state["step"]
        degree = zero_degree_of(res.spec)
        check(degree == 0, f"zero degree {degree} on a data axis of one")
        ck = ShardedCheckpointer(root, mesh_axes={"data": 1},
                                 zero_degree=degree)
        t0 = time.perf_counter()
        check(ck.save_checkpoint(step, res.state, StorageType.DISK),
              "zero: the sharded save failed")
        ck.close()
        summary["persist_s"] = time.perf_counter() - t0
        metas = ckpt_persist.load_step_metas(ck.engine.storage, root, step)
        check(bool(metas) and all(m.zero_degree == 0
                                  for m in metas.values()),
              "zero: a meta is not stamped with degree 0")
        unlink_segments(os.environ["DLROVER_TPU_JOB_NAME"])
        want_bytes = state_bytes(res)
        del res, opt
        torch.cuda.empty_cache()
        fresh = auto_accelerate(llama(seed + 1),
                                bf16_master_weights(adamw(LLAMA_LR)), batch,
                                token_loss, spec=ParallelSpec(), device=dev)
        ck = FlashCheckpointer(root)
        t0 = time.perf_counter()
        restored = ck.load_checkpoint(fresh.state)[0]
        ck.close()
        summary["restore_s"] = time.perf_counter() - t0
        check(restored == step, f"zero: restored step {restored}, want "
              f"{step}")
        bad = differing(state_bytes(fresh), want_bytes)
        check(not bad, f"the zero snapshot restored with leaves {bad} "
              "differing")
        log(f"[zero {label}] snapshot of step {step}: every leaf restored "
            "bit for bit on one device")
        del fresh, want_bytes
        torch.cuda.empty_cache()
        # ZeRO-1 beside fsdp and tensor: the slices cut from the
        # FSDP2-over-tensor-parallel shards.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        res = accelerate_on_mesh(
            llama(seed), bf16_master_weights(adamw(LLAMA_LR)), batch,
            token_loss, create_mesh([("data", 1), ("fsdp", 1),
                                     ("tensor", 1)], dev),
            device=dev, zero=True)
        opt = res.state["opt"]
        check(isinstance(opt, ZeroOptimizer) and opt.slices,
              f"zero x fsdp x tensor: the optimizer is a "
              f"{type(opt).__name__} of {len(getattr(opt, 'slices', ()))} "
              "slices")
        check(res.module.vocab_mesh is not None,
              "zero x fsdp x tensor: the embedding is not vocab-parallel")
        stats = mesh_window(f"{label} zero data x fsdp x tensor", res, batch,
                            cfg, base, traced=0, steps=TWO_AXIS_STEPS,
                            fused=False)[0]
        windows[f"zero {label} data x fsdp x tensor"] = stats["launches"]
        check(stats["losses"] == want,
              f"zero x fsdp x tensor losses {stats['losses']} differ from "
              f"one device's {want}")
        state_gib, buffers_gib = zero_state_gib(opt)
        summary["zero data x fsdp x tensor"] = {
            **{k: stats[k] for k in ("step_ms", "peak_mem_gib")},
            "sliced_leaves": len(opt.slices), "state_gib": state_gib,
            "slice_buffers_gib": buffers_gib,
            "step_over_one_device": stats["step_ms"]
            / summary["one device"]["step_ms"]}
        del res, opt
        torch.cuda.empty_cache()
        zero_adam8_masters(seed, windows, summary, dev, root, llama, cfg,
                           batch)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        xl_batch = np.random.default_rng(seed).integers(
            0, XL.vocab_size, (XL_BATCH, SEQ), dtype=np.int64)
        with PortLog() as messages:
            res = accelerate_on_mesh(
                GPT(XL, device="cuda", generator=gen), adam8bit(XL_LR),
                xl_batch, token_loss, create_mesh([("data", 1)], dev),
                device=dev, zero=True)
        warned = [m for m in messages if "no optimizer-state leaf" in m]
        check(bool(warned), "zero adam8bit: JAX's warning was not logged")
        check(not isinstance(res.state["opt"], ZeroOptimizer),
              "zero adam8bit: the 8-bit moments were sliced")
        stats = mesh_window("gpt2-xl adam8bit zero", res, xl_batch, XL, 0,
                            traced=0)[0]
        windows["zero gpt2-xl adam8bit"] = stats["launches"]
        check(stats["losses"] == xl_one, f"zero adam8bit losses "
              f"{stats['losses']} differ from one device's {xl_one}")
        summary["gpt2-xl adam8bit"] = {"warning": warned[0],
                                       "step_ms": stats["step_ms"]}
        del res
        torch.cuda.empty_cache()
    log("[zero] " + json.dumps(summary))


def zero_adam8_masters(seed, windows, summary, dev, root, llama, cfg,
                       batch):
    """``[zero]``'s 8-bit Adam under sliced masters: the LLaMA preset
    (4 x 2048, "dots") under ``bf16_master_weights(adam8bit)`` with
    ``zero=True`` on ("data", 1) beside one device, WARMUP steps and a
    window of ``TWO_AXIS_STEPS`` each: the losses bit for bit; one
    device launches the fused kernel once a step over the masters, ZeRO
    the unfused one once a step over every whole leaf (the moments
    whole, the masters sliced); the sliced masters' and the whole
    moments' GiB; the snapshot persisted (degree 0) and restored into a
    fresh one-device trainer bit for bit."""
    from dlrover_tpu_torch.accel.zero import ZeroAdam8Optimizer

    label = f"llama B{batch.shape[0]} S{batch.shape[1]} bf16 adam8bit"

    def make():
        return bf16_master_weights(adam8bit(LLAMA_LR))

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    one = auto_accelerate(llama(seed), make(), batch, token_loss,
                          spec=ParallelSpec(), device=dev)
    stats = mesh_window(f"{label} one device", one, batch, cfg, base,
                        traced=0, steps=TWO_AXIS_STEPS)[0]
    windows[f"zero {label} one device"] = stats["launches"]
    want, one_ms = stats["losses"], stats["step_ms"]
    del one
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    res = accelerate_on_mesh(llama(seed), make(), batch, token_loss,
                             create_mesh([("data", 1)], dev), device=dev,
                             zero=True)
    opt = res.state["opt"]
    check(isinstance(opt, ZeroAdam8Optimizer),
          f"zero adam8bit masters: the optimizer is a {type(opt).__name__}")
    stats = mesh_window(f"{label} zero", res, batch, cfg, base, traced=0,
                        steps=TWO_AXIS_STEPS, fused=False, unfused=True)[0]
    windows[f"zero {label}"] = stats["launches"]
    check(stats["losses"] == want, f"zero adam8bit masters: losses "
          f"{stats['losses']} differ from one device's {want}")
    gib = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                         for t in ts) / 2**30
    moments = opt.inner.inner.state
    out = {"step_ms": stats["step_ms"], "one_device_step_ms": one_ms,
           "peak_mem_gib": stats["peak_mem_gib"],
           "sliced_masters_gib": gib(opt.inner.master.values()),
           "whole_moments_gib": gib(t for m in (moments.m, moments.v)
                                    for qt in m.values() for t in qt),
           "adam8_launches": stats["launches"].get("adam8", 0)}
    step = res.state["step"]
    ck = ShardedCheckpointer(root, mesh_axes={"data": 1}, zero_degree=0)
    t0 = time.perf_counter()
    check(ck.save_checkpoint(step, res.state, StorageType.DISK),
          "zero adam8bit masters: the sharded save failed")
    ck.close()
    out["persist_s"] = time.perf_counter() - t0
    unlink_segments(os.environ["DLROVER_TPU_JOB_NAME"])
    want_bytes = state_bytes(res)
    del res, opt, moments
    torch.cuda.empty_cache()
    fresh = auto_accelerate(llama(seed + 1), make(), batch, token_loss,
                            spec=ParallelSpec(), device=dev)
    ck = FlashCheckpointer(root)
    t0 = time.perf_counter()
    restored = ck.load_checkpoint(fresh.state)[0]
    ck.close()
    out["restore_s"] = time.perf_counter() - t0
    check(restored == step, f"zero adam8bit masters: restored step "
          f"{restored}, want {step}")
    bad = differing(state_bytes(fresh), want_bytes)
    check(not bad, f"the zero adam8bit masters snapshot restored with "
          f"leaves {bad} differing")
    summary[label] = out
    log(f"[zero {label}] " + json.dumps(out))
    del fresh, want_bytes
    torch.cuda.empty_cache()


def search_phase(seed, measured):
    """``auto_accelerate(spec="auto")`` on the LLaMA preset chooses
    ``ParallelSpec()`` on the one card; then ``estimate(...).step_s`` of
    each window ``measured`` holds (step ms by window, with its config,
    batch and every step's ms) beside it. Only the LLaMA windows the derate is
    calibrated on are held to +-30%, each against the median of every
    step of its policy's rounds: a stall of the host in one step is no
    step the cost model describes."""
    from dlrover_tpu_torch.accel import search

    b, seq = LLAMA_RUNS[0][:2]
    cfg = LlamaConfig.preset(seq)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, seq), dtype=np.int64)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    res = auto_accelerate(Llama(cfg, device="cuda", generator=gen),
                          adam8bit(LLAMA_LR), batch, token_loss, spec="auto")
    ranking = [(str(s), e.step_s * 1e3, e.total_bytes / 2**30)
               for s, e in res.search_ranking]
    check(res.spec == ParallelSpec(), f"search chose {res.spec}")
    check(res.search_ranking[0][0] == ParallelSpec(),
          f"search ranked {ranking}")
    del res
    torch.cuda.empty_cache()
    hbm = torch.cuda.get_device_properties(0).total_memory
    out = {"chosen": ranking, "mfu_derate": search.MFU_DERATE, "windows": {}}
    for label, (wcfg, rows, step_ms, gaps) in measured.items():
        est = search.estimate(search.ModelProfile.from_config(wcfg),
                              ParallelSpec(), rows, hbm)
        out["windows"][label] = {
            "measured_ms": step_ms, "estimate_ms": est.step_s * 1e3,
            "ratio": est.step_s * 1e3 / step_ms, "step_gaps_ms": gaps,
            "estimate_gib": est.total_bytes / 2**30,
            "mfu": wcfg.flops_per_token() * rows * wcfg.max_seq_len
            / (step_ms / 1e3) / PEAK_BF16}
    log("[search] " + json.dumps(out))
    for label in ("llama none", "llama dots"):
        ratio = out["windows"][label]["ratio"]
        check(0.7 < ratio < 1.3, f"search: {label} estimate over measured "
              f"{ratio} ({out['windows'][label]['estimate_ms']} ms over "
              f"{out['windows'][label]['measured_ms']} ms, the median of "
              f"{out['windows'][label]['step_gaps_ms']}), want within 30%")


# ------------------------------------------------------- pipelines


def unpipelined(cfg):
    return dataclasses.replace(cfg, pipeline_stages=0, pipeline_repeats=1,
                               pipeline_microbatches=0)


def pipe_first_step(label, cfg, model_cls, batch, seed, want=None):
    """The pipelined model's logits and loss on ``batch`` at the seed's
    weights against the unpipelined model of the same seed (the same
    weights, layer by logical layer) run microbatch by microbatch: the
    same blocks on the same rows, so bit for bit. ``want``: those
    logits, when an earlier call made them. Returns the loss and the
    unpipelined logits."""
    toks = torch.from_numpy(batch).cuda()
    m = cfg.pipeline_microbatches
    mb = toks.shape[0] // m

    def build(c):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return model_cls(c, device="cuda", generator=gen)

    with torch.no_grad():
        if want is None:
            dense = build(unpipelined(cfg))
            want = torch.cat([dense(toks[i * mb:(i + 1) * mb])
                              for i in range(m)])
            del dense
            torch.cuda.empty_cache()
        pipe = build(cfg)
        reset_counts()
        got = pipe(toks)
        fwd = read_counts()[attn.kernel_name("flash_fwd", cfg.head_dim)]
        ticks = pipe.pipeline.ticks
        del pipe
    got_loss, want_loss = float(loss_fn(got, toks)), float(loss_fn(want, toks))
    err = (got.float() - want.float()).abs().max().item()
    same = torch.equal(got, want)
    log(f"[pipe {label}] first step against the unpipelined model "
        f"microbatch by microbatch: logits equal {same} (max |err| "
        f"{err:.3e}), loss {got_loss!r} vs {want_loss!r}, {fwd} forward "
        f"kernels, {ticks} ticks")
    check(fwd == m * cfg.num_layers, f"{label}: {fwd} forward kernels")
    check(same, f"{label}: logits differ from the unpipelined model's by "
          f"{err}")
    check(got_loss == want_loss, f"{label}: loss {got_loss} vs {want_loss}")
    del got
    torch.cuda.empty_cache()
    return got_loss, want


def pipe_rank_adam8(seed, errs):
    """``[pipe]``: the fused 8-bit Adam launch that pipe rank 0 of 2
    issues for GPT-2 xl under GPipe 4 x 4 (``XL_GPIPE``, bf16). Its
    optimizer binds stages [0, 2)'s parameters (laid out as a pipe
    rank's stages, ``Layout.stages`` 4) and the ends the first rank
    holds (``wte``, ``wpe``): its leaves are ``StageBlock``s of the
    global ones, its table the stages' rows. Its state is made rows
    [0, 2) of a whole model's random state (views), so one launch from
    random gradients is held to the plain version leaf by leaf
    (``adam8_errors`` / ``adam8_failures``; its largest |err| into
    ``errs``), and the rows of stages [2, 4) are checked untouched, bit
    for bit. Then 10 launches timed, beside the bound of the bytes the
    rank's rows move."""
    from dlrover_tpu_torch.accel.sharding import Layout, set_layout

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = GPT(XL_GPIPE, device="cuda", generator=gen)
    whole = {n: p.detach() for n, p in model.named_parameters()}
    mine = {n: p for n, p in whole.items() if n in ("wte.weight", "wpe")
            or n.startswith(("pipeline.stages.0.", "pipeline.stages.1."))}
    stage = Layout(None, (None,), placed=(0,), stages=XL_GPIPE.pipeline_stages)
    for n, p in mine.items():
        if n.startswith("pipeline."):
            set_layout(p, stage)
    tx = adam8bit(XL_LR)
    opt = tx(mine.items())
    full = tx.init(whole)
    for qt in list(full.m.values()) + list(full.v.values()):
        qt.q.copy_(torch.randint(-127, 128, qt.q.shape, generator=gen,
                                 device="cuda", dtype=torch.int8))
        qt.scale.copy_(torch.rand(qt.scale.shape, generator=gen,
                                  device="cuda") * 1e-3)
    rows = {}
    for path, leaf in opt._leaves.items():
        pair = (full.m[path], full.v[path])
        if leaf.index is not None:
            lo, hi = leaf.index[0]
            check((lo, hi) == (0, 2), f"[pipe] {path} holds stages {lo, hi}")
            pair = tuple(lowbit.QTensor(qt.q[lo:hi], qt.scale[lo:hi])
                         for qt in pair)
        rows[path] = pair
    check(set(rows) == set(opt.state.m), "[pipe] the rank's leaves")
    opt.state = lowbit.Adam8bitState(opt.state.step,
                                     {k: r[0] for k, r in rows.items()},
                                     {k: r[1] for k, r in rows.items()})
    staged = [k for k, leaf in opt._leaves.items() if leaf.index]
    rest = {k: [t[2:].clone() for qt in (full.m[k], full.v[k]) for t in qt]
            for k in staged}
    grads = {n: (torch.randn(p.shape, generator=gen, device="cuda")
                 * 1e-2).to(p.dtype) for n, p in mine.items()}
    before = {n: p.clone() for n, p in mine.items()}
    prior = {k: tuple(lowbit.QTensor(qt.q.clone(), qt.scale.clone())
                      for qt in r) for k, r in rows.items()}
    names = list(mine)
    reset_counts()
    opt.update_and_apply([grads[n] for n in names], [mine[n] for n in names])
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["adam8_fused"] == 1 and launches["adam8"] == 0,
          f"[pipe] launches {launches}")
    bc = 1 - tx._betas[opt.state.step.device] ** opt.state.step
    worst = 0.0
    for path, leaf in opt._leaves.items():
        shape = leaf.local_shape
        ref = lowbit._plain_blocks([grads[n] for n in leaf.names],
                                   *prior[path], bc, shape, tx.hp,
                                   p=[before[n] for n in leaf.names])
        # The random moments reach the padding: its outputs are not kept.
        ref = (lowbit._blocks_of(lowbit._unblocks(ref[0], shape, 256),
                                 256),) + ref[1:]
        got = (lowbit._blocks_of(lowbit._leaf(
            [mine[n] for n in leaf.names], shape), 256),) + tuple(
            t.reshape(-1, 256) if t.dtype == torch.int8 else t.reshape(-1)
            for qt in rows[path] for t in qt)
        e = lowbit.adam8_errors(got, ref)
        bad = lowbit.adam8_failures(e)
        check(not bad, f"[pipe] adam8_fused {path}: {bad}")
        worst = max(worst, e["max_abs_err"])
        del ref, got
    errs["adam8_fused"] = max(errs["adam8_fused"], worst)
    for k in staged:
        now = [t[2:] for qt in (full.m[k], full.v[k]) for t in qt]
        check(all(torch.equal(a, b) for a, b in zip(now, rest[k])),
              f"[pipe] stages [2, 4) of {k} moved")
    del before, prior, rest
    torch.cuda.empty_cache()
    ms = time_ms(lambda: opt.update_and_apply(
        [grads[n] for n in names], [mine[n] for n in names]), iters=10)
    values = sum(p.numel() for p in mine.values())
    blocks = sum(qt.scale.numel() for qt in opt.state.m.values())
    nbytes = values * 2 * 3 + 2 * (blocks * 256 + blocks * 4) * 2
    bound = nbytes / HBM_BYTES_S * 1e3
    out = {"stages": [0, 2], "of": XL_GPIPE.pipeline_stages,
           "values": values, "whole_values": sum(p.numel()
                                                 for p in whole.values()),
           "leaves": len(opt._leaves), "stage_leaves": len(staged),
           "launches": launches, "max_abs_err": worst, "ms": ms,
           "bound_ms": bound, "bound_by": "bytes"}
    log("[pipe rank adam8] " + json.dumps(out))
    del opt, full, model, whole, mine, grads
    torch.cuda.empty_cache()
    return out


def pipeline_phases(seed, windows, unpiped, errs):
    """GPT-2 xl under GPipe (4 x 4) and the circular schedule (4 x 2 x 4)
    and the LLaMA preset under GPipe (2 x 4), each at full width
    through ``Trainer.fit`` with ``adam8bit`` and remat "dots": the first
    step's logits and loss equal the unpipelined model's run microbatch
    by microbatch (and so GPipe's and circular's first losses are
    equal), 2 warm-up steps, a window of PIPE_STEPS (each flash kernel
    M times a layer a step, the fused 8-bit Adam once; the ticks JAX's
    formula; the loss falling), a traced step; each beside the
    unpipelined "dots" step of this call (``unpiped``: each family's
    remat-rounds summary); after each window, each 8-bit Adam kernel's
    one launch over the pipelined leaves (a stage's layers share its
    blocks: a row of the kernel's table a stage) held to the plain
    version leaf by leaf, from random gradients (its largest |err| into
    ``errs``). Then the GPipe run again on an NCCL world of one with a
    ("pipe", 1) mesh: its window's losses equal the one-device run's bit
    for bit."""
    import torch.distributed as dist

    from dlrover_tpu_torch.accel.pipeline import circular_ticks

    summary, first, losses = {}, {}, {}
    runs = (("gpt2-xl gpipe P4 M4", XL_GPIPE, GPT, XL_BATCH, SEQ, XL_LR,
             "gpt2-xl"),
            ("gpt2-xl circular P4 C2 M4", XL_CIRCULAR, GPT, XL_BATCH, SEQ,
             XL_LR, "gpt2-xl"),
            ("llama gpipe P2 M4", LLAMA_PIPE, Llama, LLAMA_RUNS[0][0],
             LLAMA_RUNS[0][1], LLAMA_LR, "llama"))
    batches, dense = {}, {}
    for label, cfg, cls, b, seq, lr, family in runs:
        batch = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (b, seq), dtype=np.int64)
        # GPipe's unpipelined reference serves the circular run too.
        want, dense[family] = pipe_first_step(label, cfg, cls, batch, seed,
                                              dense.pop(family, None))
        launches, trainer, batch, stats = train(
            label, cfg, adam8bit(lr), b, PIPE_STEPS, seed, model_cls=cls,
            seq=seq)
        windows[f"pipe {label}"] = launches
        check(stats["init_loss"] == want, f"{label}: first training loss "
              f"{stats['init_loss']} vs the unpipelined {want}")
        first[label], losses[label], batches[label] = \
            stats["init_loss"], stats["losses"], batch
        ticks = trainer.module.pipeline.ticks
        per = circular_ticks(cfg.pipeline_microbatches, cfg.pipeline_stages,
                             cfg.pipeline_repeats)
        check(ticks == (WARMUP + PIPE_STEPS) * per,
              f"{label}: {ticks} ticks in {WARMUP + PIPE_STEPS} steps, "
              f"want {per} a step")
        prof = profile_window(label, trainer, batch, stats["step_ms"],
                              steps=1)
        opt = trainer.state["opt"]
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        grads = {n: (torch.randn(p.shape, generator=gen, device="cuda")
                     * 1e-3).to(p.dtype) for n, p in opt.params.items()}
        for name, err in check_step_tables(opt, grads).items():
            errs[name] = max(errs[name], err)
        del opt, grads
        base = unpiped[family]
        summary[label] = {
            **{k: stats[k] for k in ("step_ms", "tokens_per_s", "mfu",
                                     "peak_mem_gib")},
            "busy_share": prof["kernel_busy_share"],
            "kernel_ms": prof["kernel_ms_per_step"],
            "ticks_per_step": per,
            "unpipelined_dots": {k: base[k] for k in (
                "median_step_ms", "tokens_per_s", "mfu", "peak_mem_gib",
                "busy_share")},
            "step_over_unpipelined": stats["step_ms"]
            / base["median_step_ms"],
        }
        log(f"[pipe {label}] " + json.dumps(summary[label]))
        del trainer
        torch.cuda.empty_cache()
    del dense
    torch.cuda.empty_cache()
    gpipe, circ = (f"gpt2-xl {s}" for s in ("gpipe P4 M4",
                                             "circular P4 C2 M4"))
    check(first[gpipe] == first[circ], f"GPipe's first loss {first[gpipe]} "
          f"vs circular's {first[circ]}")
    label = "gpt2-xl gpipe P4 M4 on ('pipe', 1)"
    with world_of_one("pipe") as (dev, _):
        mesh = create_mesh([("pipe", 1)], dev)
        check(dist.get_backend() == "nccl", "the mesh is not on NCCL")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        res = accelerate_on_mesh(
            GPT(XL_GPIPE, device="cuda", generator=gen), adam8bit(XL_LR),
            batches[gpipe], token_loss, mesh, device=dev)
        check(res.mesh is mesh, f"{label}: not on the mesh")
        stats = mesh_window(label, res, batches[gpipe], XL_GPIPE, 0,
                            traced=1, steps=PIPE_STEPS)[0]
        windows[f"pipe {label}"] = stats["launches"]
        check(stats["losses"] == losses[gpipe],
              f"{label}: losses {stats['losses']} differ from one device's "
              f"{losses[gpipe]}")
        summary[label] = {k: stats[k] for k in ("step_ms", "peak_mem_gib",
                                                "busy_share", "kernel_ms")}
        del res
        torch.cuda.empty_cache()
    log("[pipe] " + json.dumps(summary))


def checkpoint_phases(seed, windows):
    """Phases (a)-(c) with the agent's saver running in this process; adds
    each phase's kernel launches to ``windows``; cleans up after itself."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"ckpt-smoke-{os.getpid()}")
    job = ckpt_setup(root)
    try:
        AsyncCheckpointSaver.start_async_saving_ckpt()
        for label, phase in (("gpt2-124m", ckpt_gpt2), ("gpt2-xl", ckpt_xl)):
            t0 = time.perf_counter()
            windows[f"ckpt {label}"], _ = phase(seed, root)
            unlink_segments(job)
            torch.cuda.empty_cache()
            log(f"[ckpt {label}] phase wall {time.perf_counter() - t0:.1f}s")
        # A fresh saver for the drill's children.
        AsyncCheckpointSaver.stop()
        AsyncCheckpointSaver.start_async_saving_ckpt()
        t0 = time.perf_counter()
        crash_drill(seed, root)
        log(f"[ckpt crash] phase wall {time.perf_counter() - t0:.1f}s")
    finally:
        ckpt_cleanup(job, root)


class Phases:
    """Prints each phase's wall time as it ends."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, name):
        t = time.perf_counter()
        log(f"[phase] {name}: {t - self.t0:.1f}s")
        self.t0 = t


def d128_kernels(gen, errs):
    """The head_dim-128 kernels against their plain versions at the LLaMA
    preset's attention shapes (B 4, S 2048 and B 1, S 8192; 16 heads,
    causal) and the pipelined preset's (B 1, S 2048), non-causal, at a ragged S (causal and not), at S 192, at
    B 1 H 1 S 128, at B 3 H 5 S 1000 and at B 1 H 40 S 2048 (causal and
    not); then each timed at
    both shapes, alone and through its wrapper, beside its plain version,
    SDPA's forward and ATen's flash backward. Adds the errors to
    ``errs``; returns the times and bounds at B 4, S 2048."""
    heads = LlamaConfig.preset().num_heads
    shapes = {f"llama B{b} S{s}": (b, s) for b, s, _ in LLAMA_RUNS}
    for label, (b, s) in shapes.items():
        for name, err in compare(*qkv_do(gen, b, s, heads, 128), True,
                                 f"d128 causal {label} H{heads}"
                                 ).items():
            errs[name] = max(errs[name], err)
        torch.cuda.empty_cache()
    # The pipelined preset's shape: one row a microbatch, 16 (b, h) items.
    b = LLAMA_RUNS[0][0] // LLAMA_PIPE.pipeline_microbatches
    s = LLAMA_RUNS[0][1]
    for name, err in compare(*qkv_do(gen, b, s, heads, 128), True,
                             f"d128 causal pipe B{b} S{s} H{heads}").items():
        errs[name] = max(errs[name], err)
    compare(*qkv_do(gen, 2, 1024, 4, 128), False, "d128 non-causal B2 S1024")
    compare(*qkv_do(gen, 2, 1000, 4, 128), True, "d128 causal ragged B2 S1000")
    compare(*qkv_do(gen, 2, 192, 4, 128), True, "d128 causal B2 S192")
    # Shapes that strain the forward's walk: a grid of one block with one
    # item of one tile; 120 items (fewer than the SMs) with ragged and
    # masked tiles; a ragged S without the mask.
    compare(*qkv_do(gen, 1, 128, 1, 128), True, "d128 causal B1 H1 S128")
    compare(*qkv_do(gen, 3, 1000, 5, 128), True,
            "d128 causal ragged B3 H5 S1000")
    compare(*qkv_do(gen, 2, 1000, 4, 128), False,
            "d128 non-causal ragged B2 S1000")
    # 40 (b, h) whose K and V do not fit in half the L2 cache: the
    # forward walks them in groups, the last one short.
    compare(*qkv_do(gen, 1, 2048, 40, 128), True, "d128 causal B1 H40 S2048")
    compare(*qkv_do(gen, 1, 2048, 40, 128), False,
            "d128 non-causal B1 H40 S2048")
    timing = {}
    for label, (b, s) in shapes.items():
        x = qkv_do(gen, b, s, heads, 128)
        repeat_bwd_bitwise(*x, label)
        timing[label], yard = time_kernels(*x)
        dq_ms = timing[label]["flash_bwd_dq_d128"]["ms"]
        pair = dq_ms + timing[label]["flash_bwd_dkv_d128"]["ms"]
        bound = bounds(b, s, heads, 128, True)
        log("[timing] " + json.dumps({
            "shape": f"{label} H{heads} D128", "kernels": timing[label],
            "bounds": bound, "yardstick": yard, "dq_plus_dkv_ms": pair,
            "dq_plus_dkv_over_aten_bwd": pair / yard["aten_flash_bwd_ms"]}))
        log("[timing] d128 dQ " + json.dumps({
            "shape": f"{label} H{heads}", "ms": dq_ms,
            "bound_ms": bound["flash_bwd_dq_d128"]["bound_ms"],
            "share_of_bound": bound["flash_bwd_dq_d128"]["bound_ms"] / dq_ms,
            "dq_plus_dkv_over_aten_bwd": pair / yard["aten_flash_bwd_ms"],
            "sass_highest_register": SASS_REGISTERS.get(
                "bwd_dq_kernel<128>")}))
        del x
        torch.cuda.empty_cache()
    b, s, _ = LLAMA_RUNS[0]
    return timing[f"llama B{b} S{s}"], bounds(b, s, heads, 128, True)


def repeat_bwd_bitwise(q, k, v, do, label):
    """Two dQ and two dK/dV launches on the same inputs give the same
    bits: the kernels use no atomics, which the bit-for-bit checks of
    remat policies and pipelines rest on."""
    _, lse, delta, dq, dk, dv = run_kernels(q, k, v, do, True)
    dq2 = attn.flash_bwd_dq(q, k, v, do, lse, delta, True)
    dk2, dv2 = attn.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    check(torch.equal(dq, dq2), f"dQ {label}: two launches differ")
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
          f"dK/dV {label}: two launches differ")
    log(f"[kernels] d128 {label}: two dQ and two dK/dV launches bit for "
        "bit equal")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, inputs and batch")
    parser.add_argument("--crash-child", nargs=4, default=None,
                        metavar=("MODE", "DIR", "OUT", "SEED"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.crash_child:
        return crash_child(args.crash_child)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    phase = Phases()
    build_kernels()
    phase("build")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    shapes = {"gpt2-124m": (BATCH, 12), "gpt2-xl": (XL_BATCH, XL.num_heads)}
    flash_inputs, errs = {}, {name: 0.0 for name in FLASH + FLASH128}
    for label, (b, h) in shapes.items():
        flash_inputs[label] = qkv_do(gen, b, SEQ, h=h)
        for layout, x in (("contiguous", flash_inputs[label]),
                          ("fused qkv", fused_qkv(*flash_inputs[label]))):
            for name, err in compare(*x, True, f"causal B{b} H{h} S{SEQ} "
                                     f"{layout}").items():
                errs[name] = max(errs[name], err)
    # The pipelined GPT-2 xl's shape: one row a microbatch, 25 (b, h)
    # items, fewer than the SMs; in both layouts, as the model passes it.
    b, h = XL_BATCH // XL_GPIPE.pipeline_microbatches, XL.num_heads
    x = qkv_do(gen, b, SEQ, h=h)
    for layout, y in (("contiguous", x), ("fused qkv", fused_qkv(*x))):
        for name, err in compare(*y, True, f"pipe causal B{b} H{h} S{SEQ} "
                                 f"{layout}").items():
            errs[name] = max(errs[name], err)
    del x, y
    compare(*qkv_do(gen, 4, SEQ), False, f"non-causal B4 S{SEQ}")
    compare(*qkv_do(gen, 2, 1000), True, "causal ragged B2 S1000")
    compare(*qkv_do(gen, 2, 192), True, "causal B2 S192")
    errs.update(check_adam8(gen))
    phase("kernels vs plain (head_dim 64, 8-bit Adam)")

    timing = {}
    for label, (b, h) in shapes.items():
        x = flash_inputs.pop(label)
        timing[label], yard = time_kernels(*x)
        fused_times, _ = time_kernels(*fused_qkv(*x), yardsticks=False)
        pair = timing[label]["flash_bwd_dq"]["ms"] + \
            timing[label]["flash_bwd_dkv"]["ms"]
        log("[timing] " + json.dumps({
            "shape": f"{label}: B{b} H{h} S{SEQ}", "kernels": timing[label],
            "kernels_fused_qkv": fused_times,
            "bounds": bounds(b, SEQ, h, 64, True), "yardstick": yard,
            "dq_plus_dkv_ms": pair,
            "dq_plus_dkv_over_aten_bwd": pair / yard["aten_flash_bwd_ms"]}))
        del x
    times, bound = timing["gpt2-124m"], bounds(BATCH, SEQ, 12, 64, True)
    torch.cuda.empty_cache()
    phase("flash timing (head_dim 64)")

    times128, bound128 = d128_kernels(gen, errs)
    phase("flash head_dim 128: vs plain and timing")

    model_check(args.seed)
    model_check(args.seed, Llama, LlamaConfig.preset())
    phase("model checks")
    windows = {}
    # The step ms of windows the strategy search's estimate is held to:
    # (config, batch rows, ms).
    measured = {}
    windows["gpt2-124m"], trainer, batch, stats = train(
        "gpt2-124m", GPTConfig(**GPT2), adamw(3e-4), BATCH, STEPS, args.seed)
    measured["gpt2-124m"] = (GPTConfig(**GPT2), BATCH, stats["step_ms"],
                             stats["step_gaps_ms"])
    profile_window("gpt2-124m", trainer, batch, stats["step_ms"])
    del trainer
    torch.cuda.empty_cache()
    phase("gpt2-124m")
    rounds = remat_rounds("gpt2-xl", XL, XL_POLICIES, XL_LR, XL_BATCH, SEQ,
                          args.seed, windows, XL_ROUNDS)
    unpiped = {"gpt2-xl": rounds["dots"]}
    for policy in ("none", "dots"):
        measured[f"gpt2-xl {policy}"] = (
            with_policy(XL, policy), XL_BATCH,
            rounds[policy]["median_step_gap_ms"],
            rounds[policy]["step_gaps_ms"])
    # The flagship as bench.py trains it (remat "dots"), then the
    # optax-style loop on the same trainer.
    windows["gpt2-xl"], trainer, batch, _ = train(
        "gpt2-xl", XL, adam8bit(XL_LR), XL_BATCH, REMAT_STEPS, args.seed)
    windows["gpt2-xl unfused"] = train_unfused(trainer, batch,
                                               XL_UNFUSED_STEPS)
    opt = trainer.state["opt"]
    del trainer
    torch.cuda.empty_cache()
    phase("gpt2-xl remat rounds (" + ", ".join(XL_POLICIES) + ")")
    adam8_times = time_adam8(opt, args.seed)
    for name in ("adam8", "adam8_fused"):
        errs[name] = max(errs[name], adam8_times[name]["max_abs_err"])
    log("[timing] " + json.dumps({"adam8bit whole step": adam8_times}))
    del opt
    torch.cuda.empty_cache()
    phase("8-bit Adam timing")
    optimizer_offload(args.seed, windows)
    phase("gpt2-xl optimizer offload")
    b, seq, _ = LLAMA_RUNS[0]
    rounds = remat_rounds(
        f"llama B{b} S{seq}", LlamaConfig.preset(seq), LLAMA_POLICIES,
        LLAMA_LR, b, seq, args.seed, windows, LLAMA_ROUNDS, model_cls=Llama)
    unpiped["llama"] = rounds["dots"]
    for policy in ("none", "dots"):
        measured[f"llama {policy}"] = (
            with_policy(LlamaConfig.preset(seq), policy), b,
            rounds[policy]["median_step_gap_ms"],
            rounds[policy]["step_gaps_ms"])
    phase(f"llama B{b} S{seq} remat rounds (" + ", ".join(LLAMA_POLICIES)
          + ")")
    for b, seq, steps in LLAMA_RUNS[1:]:
        label = f"llama B{b} S{seq}"
        windows[label], trainer, _, _ = train(
            label, LlamaConfig.preset(seq), adam8bit(LLAMA_LR), b, steps,
            args.seed, model_cls=Llama, seq=seq)
        del trainer
        torch.cuda.empty_cache()
        phase(label)
    agd_and_wsam(args.seed, windows)
    phase("gpt2-124m agd and wsam")
    xl_one = mesh_phases(args.seed, windows)
    phase("mesh branches on an NCCL world of one (fsdp, data, tensor)")
    zero_phases(args.seed, windows, xl_one)
    phase("zero: llama bf16 masters and gpt2-xl adam8bit on ('data', 1)")
    moe_stats, moe_launches, moe_batch = moe_train(args.seed, windows)
    measured["llama-moe"] = (MOE, MOE_BATCH, moe_stats["step_ms"],
                             moe_stats["step_gaps_ms"])
    phase("llama-moe (8 experts, top 2) at full width")
    moe_on_expert_axis(args.seed, windows, moe_stats["losses"], moe_launches,
                       moe_batch)
    phase("llama-moe on an expert axis of one; ring and ulysses bodies")
    search_phase(args.seed, measured)
    phase("search: auto on the llama preset; estimates against the windows")
    pipeline_phases(args.seed, windows, unpiped, errs)
    phase("pipelines: gpt2-xl gpipe and circular, llama gpipe, ('pipe', 1)")
    pipe_rank_adam8(args.seed, errs)
    phase("pipe rank: the fused 8-bit Adam over stages [0, 2) of 4")
    checkpoint_phases(args.seed, windows)
    phase("checkpoint")
    log(f"[phase] whole script {time.perf_counter() - t_start:.1f}s")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    rows = []
    for name, source, replaces in KERNELS:
        launches = sum(w[name] for w in windows.values())
        check(launches > 0, f"{name} never ran on the main path")
        if name in FLASH:
            t, b, lib = times[name], bound[name], times[name]["library_ms"]
        elif name in FLASH128:  # at the LLaMA preset's 4 x 2048
            t, b = times128[name], bound128[name]
            lib = times128[name]["library_ms"]
        else:  # no single PyTorch call computes blockwise 8-bit Adam
            t, b, lib = adam8_times[name], adam8_times[name], None
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": lib,
        })
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

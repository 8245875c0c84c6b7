"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which raises (and so exits non-zero) when it fails:

1. build the CUDA kernels from ``dlrover_tpu_torch/ops/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at
   the GPT-2 124M attention shape (batch*heads 16*12, seq 1024, head_dim
   64, bf16, causal), plus a non-causal and a ragged-sequence case;
3. time each kernel, its plain version and, as yardsticks the port
   never calls, PyTorch's scaled_dot_product_attention and ATen's flash
   backward; compute each kernel's bound from its bytes and FLOPs;
4. check the GPT's kernel path against its einsum path on a small input,
   then train GPT-2 124M (12 x 768, batch 16 x 1024, random weights from
   the seed, one fixed batch) through ``Trainer.fit``: 2 warm-up steps,
   then a window of 10 whose tokens over its wall time, fence to fence,
   give tokens/s; check that every kernel ran 12 times a step in the
   window and that the loss is finite and falls;
   then trace 3 more steps with torch.profiler: device time by kernel
   group and the card's busy share;
5. print the card, a ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

Without CUDA it exits non-zero and prints no result. Float32 matmuls
and convolutions run without TF32 wherever a comparison is made.
"""

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.ops import attention as attn
from dlrover_tpu_torch.ops import build
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.train.trainer import (
    LoggingCallback,
    Trainer,
    TrainerCallback,
)
from dlrover_tpu_torch.utils.profiler import device_peak_flops, mfu

PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 bytes/s
SOURCE = "dlrover_tpu_torch/ops/csrc/flash_attn.cu"
# Each kernel (named as its launch counter) and the Pallas kernel it
# replaces.
KERNELS = (
    ("flash_fwd", "dlrover_tpu/ops/attention.py:61"),
    ("flash_bwd_dq", "dlrover_tpu/ops/attention.py:179"),
    ("flash_bwd_dkv", "dlrover_tpu/ops/attention.py:230"),
)
# Kernel vs plain: bf16 outputs, and bf16 P / dS operands of the tensor-
# core products where the plain version keeps fp32. Every 64-row tile of
# every output must agree with the plain version's to attn.TILE_REL_TOL
# (1e-2) in the Frobenius norm, and the fp32 logsumexp to LSE_TOL.
LSE_TOL = 1e-3
# The GPT's kernel path against its einsum path: the Frobenius norm of
# the logits' difference over that of the einsum path's logits. The two
# paths round P to bf16 at different places; two layers of bf16 compute
# carry that to about 7e-3 on the logits.
MODEL_TOL = 2e-2
WARMUP = 2
GPT2 = dict(vocab_size=50257, max_seq_len=1024, num_layers=12, num_heads=12,
            d_model=768, attn_impl="pallas")
BATCH, SEQ, STEPS = 16, 1024, 10


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str):
    print(msg, flush=True)


def qkv_do(gen, b, s, h=12, d=64):
    return tuple(
        torch.randn((b, s, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        for _ in range(4)
    )


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
    for name, pairs in (("flash_fwd", {"o": (o, o_ref)}),
                        ("flash_bwd_dq", {"dq": (dq, dq_ref)}),
                        ("flash_bwd_dkv", {"dk": (dk, dk_ref),
                                           "dv": (dv, dv_ref)})):
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
        f" <= {LSE_TOL})")
    for out, r in report.items():
        limit = LSE_TOL if out == "lse" else attn.TILE_REL_TOL
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
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BYTES_S
        out[name] = {
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes,
        }
    return out


def time_kernels(q, k, v, do):
    causal = True
    _, lse, delta, *_ = run_kernels(q, k, v, do, causal)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
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
    for name, (kernel, plain) in fns.items():
        out[name] = {"ms": time_ms(kernel), "plain_ms": time_ms(plain, 3, 1)}
    # Yardstick only: PyTorch's fused attention on the same inputs.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["flash_fwd"]["library_ms"] = time_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True))
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
        dot, qt, kt, vt, fo, flse, cq, ck, mq, mk, 0.0, True, seed, offset))
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


def model_check(seed):
    """The GPT's kernel path against its einsum path, same weights, on a
    2-layer GPT-2-width model and a 2 x 256 batch."""
    small = dict(GPT2, num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = GPT(GPTConfig(**small), device="cuda", generator=gen)
    ref = GPT(GPTConfig(**dict(small, attn_impl="xla")), device="cuda")
    ref.load_state_dict(model.state_dict())
    toks = torch.randint(0, small["vocab_size"], (2, 256), device="cuda",
                         generator=gen)
    with torch.no_grad():
        a, b = model(toks), ref(toks)
    check(a.shape == (2, 256, small["vocab_size"]), f"logits shape {a.shape}")
    check(bool(torch.isfinite(a).all()), "non-finite logits")
    err = (a.float() - b.float()).abs().max().item()
    rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
    la, lb = float(loss_fn(a, toks)), float(loss_fn(b, toks))
    log(f"[model] kernel vs einsum path: logits ||err|| / ||ref|| {rel:.3e} "
        f"(limit {MODEL_TOL}), max |err| {err:.3e}, loss {la:.5f} vs "
        f"{lb:.5f} (limit 1e-2)")
    check(rel <= MODEL_TOL, f"kernel path vs einsum path: logits {rel}")
    check(abs(la - lb) <= 1e-2, f"loss {la} vs einsum path {lb}")


def train(seed, steps):
    cfg = GPTConfig(**GPT2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = GPT(cfg, device="cuda", generator=gen)
    batch = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int64)
    rec = Record()
    trainer = Trainer(model, adamw(3e-4), token_loss, batch,
                      spec="auto", callbacks=[rec, LoggingCallback(every=5)])
    trainer.fit(iter([batch] * WARMUP), steps=WARMUP)  # outside the window
    first = float(rec.losses[0])
    rec.losses, rec.step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.fit(iter([batch] * steps), steps=steps)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    launches = dict(attn.LAUNCHES)
    losses = [float(x) for x in rec.losses]
    log(f"[train] loss at init {first}; window losses {losses}")
    check(out["step"] == steps, f"fit stopped at {out['step']}")
    for name, count in launches.items():
        check(count == cfg.num_layers * steps,
              f"{name} launched {count} times, want {cfg.num_layers * steps}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    # End to end: every token of the window over its whole wall time,
    # fence to fence. The per-step median is the loop's own statistic.
    tok_s = BATCH * SEQ * steps / window_s
    peak = device_peak_flops(torch.device("cuda"))
    stats = {
        "steps": steps, "window_s": window_s,
        "step_ms": window_s / steps * 1e3, "tokens_per_s": tok_s,
        "mfu": mfu(tok_s, cfg.flops_per_token(), peak or PEAK_BF16),
        "median_step_gap_ms": statistics.median(rec.step_s) * 1e3,
        "flops_per_token": cfg.flops_per_token(),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "first_loss": losses[0], "last_loss": losses[-1],
        "launches": launches,
    }
    log("[train] " + json.dumps(stats))
    return launches, trainer, batch


def profile_window(trainer, batch, steps=3):
    """Device time by kernel over ``steps`` more steps of the warm trainer
    (torch.profiler, CUDA activity): the share of the window's wall time
    the card spent in kernels, and the kernels grouped by what they do."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(iter([batch] * steps), steps=steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)]
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
    log("[profile] " + json.dumps({
        "steps": steps,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "kernel_ms_per_step": total / steps / 1e3,
        "device_busy_share": total / wall_us,
        "groups_ms_per_step": {g: t / steps / 1e3 for g, t in
                               sorted(groups.items(), key=lambda x: -x[1])},
        "top_kernels_ms_per_step": [
            [e.key[:90], e.self_device_time_total / steps / 1e3, e.count]
            for e in top
        ],
    }))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights, inputs and batch")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)

    t0 = time.perf_counter()
    _, nvcc_s = build.build("flash_attn")
    attn._lib()
    log(f"[build] flash_attn: nvcc {nvcc_s:.1f}s, "
        f"{time.perf_counter() - t0:.1f}s with loading")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    q, k, v, do = qkv_do(gen, BATCH, SEQ)
    errs = compare(q, k, v, do, True, f"causal B{BATCH} S{SEQ}")
    compare(*qkv_do(gen, 4, SEQ), False, f"non-causal B4 S{SEQ}")
    compare(*qkv_do(gen, 2, 1000), True, "causal ragged B2 S1000")

    times, yard = time_kernels(q, k, v, do)
    bound = bounds(BATCH, SEQ, 12, 64, True)
    log("[timing] " + json.dumps({"kernels": times, "bounds": bound,
                                  "yardstick": yard}))
    del q, k, v, do
    torch.cuda.empty_cache()

    model_check(args.seed)
    launches, trainer, batch = train(args.seed, STEPS)
    profile_window(trainer, batch)
    del trainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    rows = []
    for name, replaces in KERNELS:
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": bound[name]["bound_ms"],
            "bound_by": bound[name]["bound_by"],
            "library_ms": times[name]["library_ms"],
        })
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Does torch.profiler keep a device record of every launch a trace makes?

    python -m dlrover_tpu_torch.utils.trace_probe [--windows 12]

Trains GPT-2 xl 1.5B on the card (bf16 params, the fused ``adam8bit``,
batch 4 x 1024, random weights from seed 0, one fixed batch) through
``Trainer.fit``, without remat and under remat "offload", and traces
``--windows`` windows of ``--steps`` steps of each, in turns in three
modes: "bare" (``device_trace``), "pad" (spin kernels and a
synchronization at the start of the trace, before its body) and
"warmup" (the pad in a warm-up cycle of the profiler's schedule, whose
records are thrown away). For each window it prints the
host calls of the traced steps that put work on the card, how many of
them have no device record in the trace and the places of the first of
those among them, and the fused 8-bit Adam's device records against the
steps; then, for each mode, the windows that lost any of the steps'
records.
"""

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import adam8bit
from dlrover_tpu_torch.train.trainer import Trainer
from dlrover_tpu_torch.utils.profiler import (
    BODY_RANGE,
    device_kernels,
    device_trace,
    launches_without_record,
)

BATCH, SEQ = 4, 1024
MODES = ("bare", "pad", "warmup")
# The pad: spin kernels (``torch.cuda._sleep``), then a synchronization.
PAD_LAUNCHES, PAD_CYCLES = 8, 10_000


@contextlib.contextmanager
def padded(warmup):
    """``device_trace`` with the pad before its body, in the trace or in
    a warm-up cycle of the profiler's schedule."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        record_function,
        schedule,
    )

    cycle = schedule(wait=0, warmup=1, active=1) if warmup else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=cycle) as prof:
        for _ in range(PAD_LAUNCHES):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        if cycle is not None:
            prof.step()
        with record_function(BODY_RANGE):
            yield prof


def window(trainer, batch, mode, steps):
    torch.cuda.synchronize()
    trace = device_trace() if mode == "bare" else padded(mode == "warmup")
    with trace as prof:
        trainer.fit(iter([batch] * steps), steps=steps)
        torch.cuda.synchronize()
    calls, lost = launches_without_record(prof.events())
    adam = sum(e.count for e in device_kernels(prof)
               if "adam8_kernel" in e.key)
    return {"mode": mode, "launches_in_steps": calls,
            "lost_in_steps": len(lost), "first_lost_in_steps": lost[:10],
            "adam8_records": adam, "steps": steps}


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--windows", type=int, default=12)
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_probe: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(f"card {card}", flush=True)
    base = dataclasses.replace(GPTConfig.gpt2_xl(), param_dtype=torch.bfloat16,
                               attn_impl="pallas")
    batch = np.random.default_rng(0).integers(
        0, base.vocab_size, (BATCH, SEQ), dtype=np.int64)
    results = []
    for policy in ("none", "offload"):
        cfg = (dataclasses.replace(base, remat=False) if policy == "none"
               else dataclasses.replace(base, remat=True,
                                        remat_policy=policy))
        model = GPT(cfg, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
        trainer = Trainer(model, adam8bit(2e-4),
                          lambda m, p, b: loss_fn(m(b), b), batch)
        trainer.fit(iter([batch] * 2), steps=2)
        for i in range(args.windows):
            r = {"policy": policy, "window": i, **window(
                trainer, batch, MODES[i % len(MODES)], args.steps)}
            print(json.dumps(r), flush=True)
            results.append(r)
        del trainer, model
        torch.cuda.empty_cache()
    for mode in MODES:
        rs = [r for r in results if r["mode"] == mode]
        print(json.dumps({
            "mode": mode, "windows": len(rs),
            "windows_losing_step_records": sum(
                r["lost_in_steps"] > 0 for r in rs),
            "lost_in_steps": [r["lost_in_steps"] for r in rs],
            "adam8_records_short": sum(
                r["adam8_records"] != r["steps"] for r in rs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

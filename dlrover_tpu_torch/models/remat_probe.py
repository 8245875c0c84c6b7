"""What remat costs the host, on GPT-2 xl.

    python -m dlrover_tpu_torch.models.remat_probe [--rounds 3] [--steps 4]
    python -m dlrover_tpu_torch.models.remat_probe --device cpu --tiny

GPT-2 xl (48 x 1600, 25 heads, bf16 params, flash attention, batch
4 x 1024; ``--tiny``: the same 48 layers, 64 wide, batch 1 x 16, fp32)
from random weights (``--seed``), forward and backward with no
optimizer:

1. **steps**: without remat and under "nothing" and "dots", in turns,
   ``--rounds`` rounds of ``--steps`` steps after 2 warm-up ones; for
   each, the host's ms from the step's start to the return of
   ``backward`` (what it takes the host to issue the step), the step's
   wall ms (after a synchronize) and, on the card, the device's ms
   (events around the step); medians over the rounds;
2. **calls**: the host's microseconds a call of what "dots" runs in place
   of a product, at each ``Dense`` product's shape of the model (50 calls
   each, fewer than the card's launch queue holds): ``product`` in a
   forward that keeps it (``mm`` and ``_Keep.put``) and in the recompute
   (``_Replay``, which hands the kept output back), against ``mm`` alone
   (what "nothing" runs in both); and from them the host ms a step that
   "dots" adds over "nothing" (the forward's and the recompute's calls
   over the model's products);
3. **profile**: one step each under "dots" and "nothing" traced by
   ``torch.profiler`` on the host: the host ms a step and calls of
   ``_Replay``, ``aten::mm`` and ``aten::bmm`` (the tracer's own cost
   included).

Prints one JSON line a part. Nothing runs on import.
"""

import argparse
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from dlrover_tpu_torch.models import remat
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn

POLICIES = ("none", "nothing", "dots")
CALLS = 50
HOST_OPS = ("_Replay", "aten::mm", "aten::bmm")


def config(tiny: bool, policy: str) -> GPTConfig:
    cfg = GPTConfig.gpt2_xl()
    if tiny:
        cfg = dataclasses.replace(cfg, d_model=64, num_heads=2,
                                  vocab_size=256, max_seq_len=16)
    else:
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    return dataclasses.replace(cfg, attn_impl="pallas",
                               remat=policy != "none",
                               remat_policy="dots" if policy == "none"
                               else policy)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_times(model, toks, dev):
    """(host ms to issue, wall ms, device ms or None) of one step."""
    _sync(dev)
    ev = None
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    loss_fn(model(toks), toks).backward()
    host = time.perf_counter() - t0
    if ev is not None:
        ev[1].record()
    _sync(dev)
    wall = time.perf_counter() - t0
    model.zero_grad(set_to_none=True)
    return host * 1e3, wall * 1e3, (ev[0].elapsed_time(ev[1])
                                    if ev is not None else None)


def steps(models, toks, dev, rounds, n):
    per = {p: {"host_ms": [], "wall_ms": [], "device_ms": []}
           for p in models}
    for r in range(rounds):
        for p in (POLICIES if r % 2 == 0 else POLICIES[::-1]):
            for _ in range(2):
                step_times(models[p], toks, dev)
            got = [step_times(models[p], toks, dev) for _ in range(n)]
            for key, i in (("host_ms", 0), ("wall_ms", 1), ("device_ms", 2)):
                if got[0][i] is not None:
                    per[p][key].append(statistics.median(g[i] for g in got))
    return {p: {k: (statistics.median(v) if v else None, v)
                for k, v in d.items()} for p, d in per.items()}


def _host_us(fn, dev, calls=CALLS):
    """Host microseconds a call of ``fn(i)``, the card idle at the start;
    the best of 5 batches."""
    best = float("inf")
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        best = min(best, time.perf_counter() - t0)
    _sync(dev)
    return best / calls * 1e6


def calls(model, toks, dev):
    """Host us a call of mm, of a kept product in the forward and of its
    replay in the recompute, at each Dense product's shape."""
    cfg = model.cfg
    rows = toks.numel()
    shapes = {}
    for name, p in model.named_parameters():
        if name.startswith("blocks.0.") and name.endswith("kernel"):
            shapes[name.split(".")[2]] = tuple(p.shape)
    out, extra_us = {}, 0.0
    for what, (k, n) in shapes.items():
        a = torch.randn(rows, k, device=dev, dtype=cfg.param_dtype,
                        requires_grad=True)
        b = torch.randn(k, n, device=dev, dtype=cfg.param_dtype,
                        requires_grad=True)
        with torch.enable_grad():
            mm = _host_us(lambda i: a.mm(b), dev)
            keep = remat._Keep("dots", 0)
            token = remat._KEEP.set(keep)
            try:
                def put(i):
                    if i == 0:
                        keep.items = []
                    remat.product(a, b)

                forward = _host_us(put, dev)
                kept = keep.items[0]
                keep.replaying = True

                def replay(i):
                    if i == 0:
                        keep.items, keep._next = [kept] * CALLS, 0
                    remat.product(a, b)

                replayed = _host_us(replay, dev)
            finally:
                remat._KEEP.reset(token)
        out[what] = {"shape": [rows, k, n], "mm_us": mm,
                     "forward_product_us": forward, "replay_us": replayed}
        extra_us += (forward - mm) + (replayed - mm)
    return {"per_product": out,
            "dots_over_nothing_host_ms_a_step":
                extra_us * cfg.num_layers / 1e3}


def profile(models, toks, dev):
    from torch.profiler import ProfilerActivity, profile as trace

    out = {}
    for p in ("nothing", "dots"):
        step_times(models[p], toks, dev)
        with trace(activities=[ProfilerActivity.CPU]) as prof:
            step_times(models[p], toks, dev)
        out[p] = {e.key: {"host_ms": e.cpu_time_total / 1e3,
                          "calls": e.count}
                  for e in prof.key_averages() if e.key in HOST_OPS}
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    models = {}
    for p in POLICIES:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        models[p] = GPT(config(args.tiny, p), device=dev, generator=gen)
    b, s = (1, 16) if args.tiny else (4, 1024)
    cfg = models["none"].cfg
    toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int64)).to(dev)
    head = {"device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "batch": [b, s]}
    print(json.dumps({"steps": steps(models, toks, dev, args.rounds,
                                     args.steps), **head}), flush=True)
    print(json.dumps({"calls": calls(models["dots"], toks, dev), **head}),
          flush=True)
    print(json.dumps({"profile": profile(models, toks, dev), **head}),
          flush=True)


if __name__ == "__main__":
    main()

"""Ablations of the flash checkpoint's staging, on the card.

Trains GPT-2 124M (AdamW, batch 16 x 1024) or GPT-2 xl 1.5B (bf16
params, fused ``adam8bit``, batch 4 x 1024) from random weights on one
fixed batch through ``Trainer.fit``, and after every step runs one
variant of the snapshot in place of the checkpointer's:

- ``none``: nothing (the step without a checkpoint);
- ``engine``: ``save_to_memory_async``, the engine as committed;
  ``engine:DUTY`` with its copy to the segment held to DUTY of the host
  link's time (``_D2H_DUTY``; 1 is the full rate); ``engine_sync:DUTY``
  the same, with the engine's waits by ``Event.synchronize()`` instead
  of polling;
- ``copy``: only the copy of every leaf into the device buffer
  (``_own_copies``, the compute stream);
- ``d2h_sync``: the copy, then from a worker thread the copy of the
  buffer into the registered segment on the side stream, waited for by
  ``Event.synchronize()`` (the engine's wait, without the publish);
- ``d2h_query``: the same, waited for by polling ``Event.query()``;
- ``d2h_blocking``: the same, the event made with ``blocking=True``;
- ``d2h_pinned``: ``d2h_sync`` into memory from ``pin_memory`` instead
  of the registered segment;
- ``d2h_main``: the copy to the segment enqueued by the loop's own
  thread (no worker thread; its event is polled at the next step);
- ``publish``: the engine's publish (lock, scalars, meta pickle) from the
  staging thread, with no copy to the segment;
- ``d2h_compute``: the copy to the segment enqueued on the compute
  stream itself, after the copy into the buffer (no overlap at all);
- ``paced:MB:DUTY``: ``d2h_sync`` in chunks of MB, one at a time, each
  followed by a pause that holds the copy to DUTY of the wall time.

A variant that finds the previous snapshot still in flight skips, as the
engine does, and counts it. With ``--agent`` the agent's saver runs in
this process (as in ``chip_smoke.py``), so the engine's lock and meta
go over its sockets. Each window is ``--steps`` steps after the
warm-up; ``none`` and ``engine`` run again last, to show the drift. For
each: wall ms a step (fence to fence), the median gap between the loop's
lag-1 fences, the median host ms of the step's dispatch and of the
snapshot call, and the skips; with ``--profile``, each window is also
traced (torch.profiler): its kernels' device ms a step, the copies'
(``Memcpy DtoH``) and the kernels' share of the traced wall time.

    python -m dlrover_tpu_torch.train.checkpoint.staging_probe \\
        [--model xl|124m] [--steps N] [--agent] [--profile] [variant ...]

Needs an NVIDIA card (the flash and Adam kernels build on first use);
nothing runs on import. Files go under ``build/staging-probe-<pid>`` and
the segment is unlinked at the end.
"""

import argparse
import concurrent.futures
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import uuid

import numpy as np
import torch

from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.common.shared_memory import SharedMemory
from dlrover_tpu_torch.models.gpt import GPT, GPTConfig, loss_fn
from dlrover_tpu_torch.optim import adam8bit, adamw
from dlrover_tpu_torch.train.checkpoint import engine as engine_module
from dlrover_tpu_torch.train.checkpoint.engine import _flatten_state, _scalars
from dlrover_tpu_torch.train.trainer import Trainer, TrainerCallback
from dlrover_tpu_torch.utils.profiler import device_kernels, device_trace

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
VARIANTS = ("none", "engine", "copy", "d2h_sync", "d2h_query",
            "d2h_blocking", "d2h_pinned", "d2h_main", "publish")


class _Gaps(TrainerCallback):
    def __init__(self):
        self.gaps = []

    def on_step_end(self, trainer, step, metrics):
        self.gaps.append(metrics["step_time_s"])


class _Hook:
    """Stands in for the checkpointer in ``Trainer.fit``: each MEMORY
    save runs ``fn(step, state)``; its host seconds go to ``times``."""

    def __init__(self, fn, times):
        self.fn, self.times = fn, times

    def save_checkpoint(self, step, state, storage_type=0, block=False):
        t0 = time.perf_counter()
        out = self.fn(step, state)
        self.times.append(time.perf_counter() - t0)
        return out


def _timed(fn, times):
    """``fn`` with each call's host seconds appended to ``times``."""

    def call(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append(time.perf_counter() - t0)
        return out

    return call


class Variants:
    def __init__(self, engine):
        self.engine = engine
        self.committed_duty = engine_module._D2H_DUTY
        self.committed_wait = engine_module._wait
        self.pool = concurrent.futures.ThreadPoolExecutor(1)
        self.inflight = None
        self.skips = 0
        self.pinned = None

    def _busy(self) -> bool:
        f = self.inflight
        if f is None:
            return False
        if isinstance(f, torch.cuda.Event):
            return not f.query()
        return not f.done()

    def _copy(self, state):
        eng = self.engine
        leaves, _ = _flatten_state(state, eng._groups)
        plan = eng._layout(leaves)
        return leaves, plan, eng._own_copies(plan, leaves)

    def _d2h(self, plan, copied, dest, blocking=False):
        stream = self.engine._copy_stream
        done = torch.cuda.Event(blocking=blocking)
        with torch.cuda.stream(stream):
            stream.wait_event(copied)
            dest[:plan.used].copy_(plan.stage, non_blocking=True)
            done.record(stream)
        return done

    def make(self, name):
        eng = self.engine
        if name == "none":
            return lambda step, state: True
        if name.startswith("engine"):
            duty = float(name.split(":")[1]) if ":" in name else None
            wait = ((lambda e: e.synchronize()) if name.startswith(
                "engine_sync") else self.committed_wait)

            def engine(step, state):
                engine_module._D2H_DUTY = duty or self.committed_duty
                engine_module._wait = wait
                return eng.save_to_memory_async(step, state)
            return engine

        def gated(fn):
            def hook(step, state):
                if self._busy():
                    self.skips += 1
                    return False
                self.inflight = fn(step, state)
                return True
            return hook

        if name == "copy":
            return lambda step, state: bool(self._copy(state))
        if name == "d2h_main":
            def main_thread(step, state):
                _, plan, (_, copied) = self._copy(state)
                return self._d2h(plan, copied, eng._shm_host)
            return gated(main_thread)
        if name == "d2h_compute":
            def on_compute(step, state):
                _, plan, _ = self._copy(state)
                eng._shm_host[:plan.used].copy_(plan.stage, non_blocking=True)
                return True
            return on_compute
        if name.startswith("paced:"):
            _, mb, duty = name.split(":")
            return gated(lambda step, state: self.pool.submit(
                self._paced, *self._copy(state)[1:], int(mb) << 20,
                float(duty)))
        if name == "publish":
            def publish(step, state):
                leaves, plan, _ = self._copy(state)
                t0 = time.perf_counter()
                return self.pool.submit(
                    eng._write_snapshot, step, plan,
                    lambda host: {"bytes": 0}, _scalars(leaves), True,
                    eng._take_gen(), t0)
            return gated(publish)
        wait = {"d2h_sync": lambda e: e.synchronize(),
                "d2h_blocking": lambda e: e.synchronize(),
                "d2h_pinned": lambda e: e.synchronize(),
                "d2h_query": _poll}[name]

        if name == "d2h_pinned" and self.pinned is None:
            self.pinned = torch.empty(eng._plan.used, dtype=torch.uint8,
                                      pin_memory=True)

        def worker(plan, copied):
            dest = self.pinned if name == "d2h_pinned" else eng._shm_host
            wait(self._d2h(plan, copied, dest,
                           blocking=name == "d2h_blocking"))

        def d2h(step, state):
            _, plan, (_, copied) = self._copy(state)
            return self.pool.submit(worker, plan, copied)
        return gated(d2h)

    def _paced(self, plan, events, chunk, duty):
        stream, dest = self.engine._copy_stream, self.engine._shm_host
        with torch.cuda.stream(stream):
            stream.wait_event(events[1])
        for off in range(0, plan.used, chunk):
            n = min(chunk, plan.used - off)
            with torch.cuda.stream(stream):
                dest[off:off + n].copy_(plan.stage[off:off + n],
                                        non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            t0 = time.perf_counter()
            _poll(done)
            time.sleep((time.perf_counter() - t0) * (1.0 / duty - 1.0))


def _poll(event):
    while not event.query():
        time.sleep(0.0005)


def _trace(on: bool):
    import contextlib

    return device_trace() if on else contextlib.nullcontext()


def _device_times(prof, steps, wall):
    events = device_kernels(prof)
    copies = sum(e.self_device_time_total for e in events
                 if "Memcpy" in e.key or "Memset" in e.key)
    dtoh = sum(e.self_device_time_total for e in events
               if "Memcpy DtoH" in e.key)
    kernels = sum(e.self_device_time_total for e in events) - copies
    return {"kernel_ms_per_step": kernels / steps / 1e3,
            "dtoh_ms_per_step": dtoh / steps / 1e3,
            "kernel_share_of_wall": kernels / 1e6 / wall,
            "top_copy_kernels": sorted(
                ([e.key[:60], e.self_device_time_total / steps / 1e3]
                 for e in events if "opy" in e.key and "Memcpy" not in
                 e.key), key=lambda x: -x[1])[:3]}


def _model(name):
    if name == "xl":
        cfg = dataclasses.replace(GPTConfig.gpt2_xl(), remat=False,
                                  param_dtype=torch.bfloat16,
                                  attn_impl="pallas")
        return cfg, adam8bit(2e-4), 4
    return GPTConfig(attn_impl="pallas"), adamw(3e-4), 16


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("xl", "124m"), default="xl")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--agent", action="store_true")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("staging_probe: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["DLROVER_TPU_JOB_NAME"] = f"probe-{uuid.uuid4().hex[:8]}"
    root = os.path.join(REPO, "build", f"staging-probe-{os.getpid()}")
    cfg, opt, batch_size = _model(args.model)
    batch = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch_size, 1024), dtype=np.int64)
    if args.agent:
        AsyncCheckpointSaver.start_async_saving_ckpt()
    gaps = _Gaps()
    model = GPT(cfg, device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(0))
    trainer = Trainer(model, opt, lambda m, p, b: loss_fn(m(b), b), batch,
                      callbacks=[gaps], checkpoint_dir=root, persist_every=0)
    ckpt = trainer.checkpointer
    engine = ckpt.engine
    try:
        trainer.fit(iter([batch] * 2), steps=2, start_step=0)
        engine.wait_staged()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
        ).stdout.strip()
        print("setup", json.dumps({
            "model": args.model, "agent": engine.agent_mode, "card": card,
            "bytes": engine.stage_log[-1]["bytes"],
            "register_s": engine.stats["register_s"]}), flush=True)
        variants = Variants(engine)
        dispatch, hook = [], []
        trainer._result.train_step = _timed(trainer._result.train_step,
                                            dispatch)
        step = 2
        order = list(args.variants) + ["none", "engine"]
        for name in order:
            trainer._ckpt = _Hook(variants.make(name), hook)
            variants.skips, gaps.gaps = 0, []
            del dispatch[:], hook[:]
            skipped = engine.stats["skipped"]
            torch.cuda.synchronize()
            with _trace(args.profile) as prof:
                t0 = time.perf_counter()
                trainer.fit(iter([batch] * args.steps),
                            steps=step + args.steps, start_step=step)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            engine.wait_staged()
            if variants.inflight is not None:
                if isinstance(variants.inflight, torch.cuda.Event):
                    variants.inflight.synchronize()
                else:
                    variants.inflight.result()
                variants.inflight = None
            step += args.steps
            out = {"step_ms": wall / args.steps * 1e3,
                   "median_gap_ms": statistics.median(gaps.gaps) * 1e3,
                   "dispatch_ms": statistics.median(dispatch) * 1e3,
                   "hook_ms": statistics.median(hook) * 1e3,
                   "skips": variants.skips + engine.stats["skipped"]
                   - skipped}
            if prof is not None:
                out.update(_device_times(prof, args.steps, wall))
            print(name, json.dumps(out), flush=True)
    finally:
        trainer._ckpt = ckpt
        trainer.close()
        AsyncCheckpointSaver.stop()
        SharedMemory.remove(engine.shm_name)
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

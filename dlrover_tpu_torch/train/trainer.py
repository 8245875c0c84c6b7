"""High-level training loop of the port — counterpart of
``dlrover_tpu/train/trainer.py``.

``Trainer`` wires ``auto_accelerate``, the lag-1 metric readback, the
device prefetcher, the flash checkpoint and HF-style callbacks into a
``fit()`` loop, so a training script is model + loss + data. The surface
is the JAX trainer's: callbacks with a ``should_stop`` flag,
``LoggingCallback``, ``evaluate()``, ``fit(pipeline=True/False)``,
``checkpoint_dir`` / ``persist_every`` / ``restore()`` / ``close()``,
and ``lr_schedule=``: the schedule the optimizer follows (a callable of
the step), whose value at each finished step the loop reports as
``metrics["lr"]`` (and ``LoggingCallback`` logs), as the JAX trainer
does.

With ``checkpoint_dir`` every step's state is snapshotted to host shared
memory (``StorageType.MEMORY``, asynchronous: the copy is enqueued
before the next step is dispatched) and every ``persist_every`` steps
persisted to disk (``StorageType.DISK``); ``fit`` resumes from the
newest snapshot, memory first, unless given ``start_step``.

``**accel_kwargs`` go to ``auto_accelerate``, as in the JAX trainer:
``offload_optimizer=True`` keeps the optimizer's big state leaves in
host memory between steps; the others raise there, naming their slice.

On a mesh (``spec`` of several degrees over as many processes, each
under torchrun) every process passes the global batch, as in the JAX
trainer; the loop copies only this rank's rows to the device
(``AccelerateResult.local_batch``, before the prefetcher's copy), the
reported loss and ``eval_loss`` are means over all ranks (over the last
stage's on a pipe mesh, which form the loss) and ``tokens_per_s``
counts the global batch. A checkpoint over several
processes is a ``ShardedCheckpointer`` (one shard a process).

Pieces that need modules of later slices raise ``NotImplementedError``
(ROADMAP queue 1): a rescale engine, master reporting (a job with a
master), chaos sites (a fault plan in the environment) and the
profiler's trace capture. The comms governor needs the master, so it
never arises here.
"""

import itertools
import time
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from dlrover_tpu_torch.accel.mesh import axis_sizes
from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.device import DeviceLike
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.train.checkpoint import (
    FlashCheckpointer,
    ShardedCheckpointer,
    StorageType,
)
from dlrover_tpu_torch.train.data.device_prefetch import (
    DevicePrefetchIterator,
    to_device,
)
from dlrover_tpu_torch.train.metrics import DeferredMetrics, batch_token_count
from dlrover_tpu_torch.utils.profiler import PhaseBreakdown


class TrainerCallback:
    """Hook points of the HF-style loop. Any hook may set
    ``trainer.should_stop = True`` to end ``fit`` after the current step.

    Under ``fit(pipeline=True)`` (the default) ``metrics["loss"]`` is
    this step's loss as a device tensor — reading it syncs on the
    current step, so read it at your own cadence; ``metrics["loss_lag1"]``
    is the previous step's loss as a float, free to read;
    ``metrics["step_time_s"]`` is the wall time between lag-1 fences.
    With ``pipeline=False`` the loop syncs every step and
    ``metrics["loss"]`` is a float (``loss_lag1`` is absent)."""

    def on_train_begin(self, trainer, start_step: int):
        pass

    def on_step_end(self, trainer, step: int, metrics: dict):
        pass

    def on_evaluate(self, trainer, step: int, metrics: dict):
        pass

    def on_save(self, trainer, step: int, storage: str):
        pass

    def on_train_end(self, trainer, step: int):
        pass


class LoggingCallback(TrainerCallback):
    """Interval logging: loss, step time, tokens/s, learning rate."""

    def __init__(self, every: int = 10):
        self.every = max(1, every)

    def on_step_end(self, trainer, step, metrics):
        if step % self.every:
            return
        parts = [f"step {step}", f"loss {float(metrics['loss']):.4f}"]
        if "step_time_s" in metrics:
            parts.append(f"{metrics['step_time_s'] * 1e3:.0f} ms/step")
        if "tokens_per_s" in metrics:
            parts.append(f"{metrics['tokens_per_s'] / 1e3:.1f}k tok/s")
        if "lr" in metrics:
            parts.append(f"lr {metrics['lr']:.2e}")
        logger.info("train | %s", " | ".join(parts))

    def on_evaluate(self, trainer, step, metrics):
        logger.info(
            "eval  | step %s | eval_loss %.4f (%s batches)",
            step, metrics["eval_loss"], metrics["eval_batches"],
        )


def _later(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} comes with the {slice_name} slice of the port "
        "(ROADMAP queue 1)"
    )


class Trainer:
    def __init__(
        self,
        model,
        optimizer,
        loss: Callable,                      # (module, params, batch) -> scalar
        sample_batch,
        spec: Any = "auto",
        checkpoint_dir: str = "",
        persist_every: int = 100,
        grad_accum: int = 1,
        profiler=None,
        report_metrics: bool = True,
        callbacks: Sequence[TrainerCallback] = (),
        lr_schedule: Optional[Callable[[int], float]] = None,
        device: DeviceLike = None,
        **accel_kwargs,
    ):
        from dlrover_tpu_torch.accel import auto_accelerate

        if profiler is not None:
            raise _later("the profiler", "chaos and observability")
        if report_metrics and env_utils.MASTER_ADDR.get():
            raise _later("master reporting", "chaos and observability")
        if env_utils.CHAOS.get():
            raise _later("chaos sites", "chaos and observability")
        self._result = auto_accelerate(
            model, optimizer, sample_batch, loss, spec=spec,
            device=device, grad_accum=grad_accum, **accel_kwargs,
        )
        self.state = self._result.state
        self._loss = loss
        self._callbacks = list(callbacks)
        self._lr_schedule = lr_schedule
        self.should_stop = False
        # Per-step phase breakdown (input / compute / collective /
        # readback) from the fences the loop takes anyway.
        self._phases = (
            PhaseBreakdown() if env_utils.STRAGGLER_PHASES.get() else None
        )
        self._persist_every = persist_every
        self._ckpt = None
        if checkpoint_dir:
            from dlrover_tpu_torch.accel.zero import zero_degree_of

            mesh = self._result.mesh
            # The ZeRO degree goes into every ShardMeta, so a restore under
            # another data degree that cannot re-slice the optimizer state
            # names both degrees instead of loading a wrong slice.
            zero = zero_degree_of(self._result.spec)
            if env_utils.NUM_PROCESSES.get() > 1:
                self._ckpt = ShardedCheckpointer(
                    checkpoint_dir,
                    mesh_axes=axis_sizes(mesh) if mesh is not None else None,
                    zero_degree=zero)
            else:
                self._ckpt = FlashCheckpointer(checkpoint_dir,
                                               zero_degree=zero)

    @property
    def checkpointer(self):
        """The flash checkpointer (None without ``checkpoint_dir``)."""
        return self._ckpt

    def restore(self) -> int:
        """Resume from the newest checkpoint, in place; returns the step
        to start from (0 when there is none)."""
        if self._ckpt is None:
            return 0
        step, self.state = self._ckpt.load_checkpoint(self.state)
        if step > 0:
            logger.info("trainer resumed from step %s", step)
        return max(0, step)

    def close(self):
        if self._ckpt is not None:
            self._ckpt.close()

    @property
    def phase_breakdown(self) -> Optional[PhaseBreakdown]:
        return self._phases

    @property
    def train_step(self):
        return self._result.train_step

    @property
    def device(self) -> torch.device:
        return self._result.device

    @property
    def module(self):
        return self._result.module

    def _fire(self, hook: str, *args):
        for cb in self._callbacks:
            try:
                getattr(cb, hook)(self, *args)
            except Exception:
                logger.exception("trainer callback %s failed", hook)

    def evaluate(self, batches: Iterable, max_batches: int = 0) -> dict:
        """Forward-only loss over an eval stream, accumulated on the
        device (one host sync for the stream): {'eval_loss', 'eval_batches'}."""
        src = (
            itertools.islice(batches, max_batches) if max_batches
            else batches
        )
        total, n = torch.zeros((), device=self.device), 0
        with torch.no_grad():
            for batch in DevicePrefetchIterator(
                    src, self.device, depth=2,
                    take=self._result.local_batch):
                total = total + self._result.forward_loss(self._loss, batch)
                n += 1
            if self._result.mesh is not None:
                dist.all_reduce(total)
                total = total / self._result.loss_ranks
        return {"eval_loss": float(total) / max(n, 1), "eval_batches": n}

    def fit(self, batches: Iterable, steps: int,
            start_step: Optional[int] = None,
            eval_batches: Optional[Callable[[], Iterable]] = None,
            eval_every: int = 0,
            eval_max_batches: int = 0,
            pipeline: bool = True,
            prefetch_depth: int = 2,
            rescale_engine=None) -> dict:
        """Run the loop; returns {'step': last, 'loss': last[, 'eval_loss']}.

        One batch per optimizer step, until ``steps``, the end of the
        data, or a callback's ``should_stop``. ``pipeline=True`` keeps
        ``prefetch_depth`` batches in flight to the device and reads the
        loss back lag-1, so the host syncs with the card only on the
        previous step; ``pipeline=False`` copies each batch inside the
        step and syncs on every step. Both compute the same losses.
        With a checkpoint, ``start_step=None`` resumes from it
        (``restore()``); each step's state is snapshotted once the step
        is dispatched, before the next one is.
        """
        if rescale_engine is not None:
            raise _later("rescale_engine", "ElasticTrainer / rescale")
        start = self.restore() if start_step is None else start_step
        if pipeline:
            it = (
                batches if isinstance(batches, DevicePrefetchIterator)
                else DevicePrefetchIterator(
                    batches, self.device, depth=prefetch_depth,
                    take=self._result.local_batch,
                )
            )
        else:
            it = iter(batches)
        deferred = DeferredMetrics()
        last_loss: Any = float("nan")
        last_eval: dict = {}
        evaluated_at = -1
        done = start
        # This rank's batch is one of `shards` slices of the global one.
        sizes = (axis_sizes(self._result.mesh)
                 if self._result.mesh is not None else {})
        shards = sizes.get("data", 1) * sizes.get("fsdp", 1)
        self.should_stop = False  # a previous fit's stop must not leak
        self._fire("on_train_begin", start)
        t_mark = time.perf_counter()
        for step in range(start, steps):
            t_in0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                logger.info("data exhausted at step %s", step)
                break
            t_step0 = time.perf_counter()
            input_s = t_step0 - t_in0
            if not pipeline:
                batch = to_device(self._result.local_batch(batch),
                                  self.device)
            self.state, metrics = self.train_step(self.state, batch)
            dispatch_s = time.perf_counter() - t_step0
            done = step + 1
            if self._ckpt is not None:
                if self._persist_every and done % self._persist_every == 0:
                    self._ckpt.save_checkpoint(done, self.state,
                                               StorageType.DISK)
                    self._fire("on_save", done, "disk")
                else:
                    # Enqueued behind step `done`, ahead of the next step.
                    self._ckpt.save_checkpoint(done, self.state,
                                               StorageType.MEMORY)
            last_loss = metrics["loss"]
            if pipeline:
                # Lag-1 fence: wait for step N-1, never for step N.
                t_f0 = time.perf_counter()
                deferred.fence()
                t_f1 = time.perf_counter()
                prev = deferred.push(done, {"loss": last_loss})
                t_f2 = time.perf_counter()
                step_metrics = {
                    "loss": last_loss,  # device tensor: syncs if read
                    "loss_lag1": prev[1]["loss"] if prev else None,
                    "step_time_s": t_f2 - t_mark,
                }
                t_mark = t_f2
            else:
                t_f0 = time.perf_counter()
                if last_loss.is_cuda:
                    torch.cuda.synchronize(last_loss.device)
                t_f1 = time.perf_counter()
                loss_host = float(last_loss)
                t_f2 = time.perf_counter()
                step_metrics = {
                    "loss": loss_host,
                    "step_time_s": t_f2 - t_step0,
                }
            if self._phases is not None:
                self._phases.split(input_s, dispatch_s, t_f1 - t_f0,
                                   t_f2 - t_f1)
            tokens = batch_token_count(batch) * shards
            if tokens:
                step_metrics["tokens_per_s"] = (
                    tokens / step_metrics["step_time_s"]
                )
            if self._lr_schedule is not None:
                step_metrics["lr"] = float(self._lr_schedule(done))
            self._fire("on_step_end", done, step_metrics)
            if (eval_batches is not None and eval_every
                    and done % eval_every == 0):
                last_eval = self.evaluate(
                    eval_batches(), max_batches=eval_max_batches
                )
                evaluated_at = done
                self._fire("on_evaluate", done, last_eval)
            if self.should_stop:
                logger.info("callback requested stop at step %s", done)
                break
        deferred.flush()  # drain the lag-1 slot before the boundary work
        if eval_batches is not None and evaluated_at != done:
            last_eval = self.evaluate(
                eval_batches(), max_batches=eval_max_batches
            )
            self._fire("on_evaluate", done, last_eval)
        self._fire("on_train_end", done)
        loss = float(last_loss)
        logger.info("trainer finished at step %s (loss %.5f)", done, loss)
        out = {"step": done, "loss": loss}
        out.update(last_eval)
        return out

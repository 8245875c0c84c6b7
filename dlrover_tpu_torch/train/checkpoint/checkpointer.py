"""User-facing flash-checkpoint API — the port of
``dlrover_tpu/train/checkpoint/checkpointer.py``. Typical loop::

    ckpt = FlashCheckpointer("/ckpts")
    step, state = ckpt.load_checkpoint(state)   # resume (memory, then disk)
    for step in range(step + 1, steps):
        state, metrics = train_step(state, batch)
        ckpt.save_checkpoint(step, state, StorageType.MEMORY)   # every step
        if step % 100 == 0:
            ckpt.save_checkpoint(step, state, StorageType.DISK)

A crash restores the last MEMORY snapshot (the agent's saver flushes it
to disk), not just the last DISK save. ``FlashCheckpointer`` is one
shard that every process holds (pure data parallel), written by the
lowest replica; ``ShardedCheckpointer`` is one shard a process, each
block written by its first replica, and restores under another mesh.
A process's rank and the world come from the package's environment or
torchrun's (``RANK``, ``WORLD_SIZE``).
"""

from typing import Any, Optional, Tuple

from dlrover_tpu_torch.common import env_utils
from dlrover_tpu_torch.common.storage import CheckpointStorage
from dlrover_tpu_torch.train.checkpoint.engine import CheckpointEngine


class StorageType:
    MEMORY = 0
    DISK = 1


class Checkpointer:
    """Base: one engine per process, storage-type dispatch."""

    def __init__(self, engine: CheckpointEngine):
        self._engine = engine

    def save_checkpoint(self, step: int, state,
                        storage_type: int = StorageType.DISK,
                        block: bool = False) -> bool:
        """MEMORY saves are asynchronous by default: the copy is enqueued
        and a staging thread finishes it, so the loop waits for
        milliseconds whatever the state's size (``block=True`` for the
        synchronous save)."""
        if storage_type == StorageType.MEMORY:
            if block:
                return self._engine.save_to_memory(step, state, block=True)
            return self._engine.save_to_memory_async(step, state)
        return self._engine.save_to_storage(step, state)

    def load_checkpoint(self, template) -> Tuple[int, Any]:
        """Returns (last_step, state); (-1, template) when no checkpoint."""
        return self._engine.load(template)

    def wait_persisted(self, step: int, timeout: float = 120.0) -> bool:
        return self._engine.wait_persisted(step, timeout)

    @property
    def engine(self) -> CheckpointEngine:
        return self._engine

    def close(self):
        self._engine.close()


class FlashCheckpointer(Checkpointer):
    """For a state every process holds in full (pure data parallel): each
    process stages to its own segment, replica 0 persists the one shard."""

    def __init__(self, checkpoint_dir: str,
                 storage: Optional[CheckpointStorage] = None,
                 keep_latest: int = 3, zero_degree: int = 0):
        super().__init__(CheckpointEngine(
            checkpoint_dir, global_shard_id=0, global_shard_num=1,
            persist_shard=True, storage=storage, keep_latest=keep_latest,
            replica_rank=env_utils.PROCESS_ID.get(),
            replica_count=env_utils.NUM_PROCESSES.get(),
            zero_degree=zero_degree,
        ))


class ShardedCheckpointer(Checkpointer):
    """One shard per process, for a sharded train state: each process
    stages its blocks and persists those it is the first replica of, so
    the state is written once across the processes; a restore assembles
    the template's blocks from any mesh's (``mesh_axes``, the saving
    mesh's ``{axis: size}``, names both topologies when it cannot).
    ``zero_degree``: the data degree a ZeRO-1 state's optimizer slices
    are cut to (``accel.zero.zero_degree_of``), stamped into every meta;
    a restore that cannot re-slice them names both degrees."""

    def __init__(self, checkpoint_dir: str,
                 storage: Optional[CheckpointStorage] = None,
                 keep_latest: int = 3, mesh_axes=None, zero_degree: int = 0):
        super().__init__(CheckpointEngine(
            checkpoint_dir,
            global_shard_id=env_utils.PROCESS_ID.get(),
            global_shard_num=env_utils.NUM_PROCESSES.get(),
            persist_shard=True, storage=storage, keep_latest=keep_latest,
            mesh_axes=mesh_axes, zero_degree=zero_degree,
        ))

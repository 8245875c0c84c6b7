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
to disk), not just the last DISK save. With one process both classes are
one shard, written by replica 0; several processes raise until the
multi-device slice (ROADMAP queue 1, item 4).
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
                 keep_latest: int = 3):
        super().__init__(CheckpointEngine(
            checkpoint_dir, global_shard_id=0, global_shard_num=1,
            persist_shard=True, storage=storage, keep_latest=keep_latest,
            replica_count=env_utils.NUM_PROCESSES.get(),
        ))


class ShardedCheckpointer(Checkpointer):
    """One shard per process, for a sharded train state."""

    def __init__(self, checkpoint_dir: str,
                 storage: Optional[CheckpointStorage] = None,
                 keep_latest: int = 3):
        super().__init__(CheckpointEngine(
            checkpoint_dir,
            global_shard_id=env_utils.PROCESS_ID.get(),
            global_shard_num=env_utils.NUM_PROCESSES.get(),
            persist_shard=True, storage=storage, keep_latest=keep_latest,
        ))

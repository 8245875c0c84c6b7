"""Flash-checkpoint metadata — the port's copy of
``dlrover_tpu/common/ckpt_meta.py``, and the pickles that carry it.

These dataclasses go into every ``.meta`` file and across the engine ↔
agent sockets as pickles. A pickle names each object's class by module
and name, so the JAX package's files and messages name
``dlrover_tpu.common.ckpt_meta.ShardMeta`` and the rest. The port writes
and reads exactly those names without importing that package:

- ``dumps`` writes the port's classes under the JAX package's module name
  (``WIRE_MODULE``), so a checkpoint or message of the port reads on a
  host with only the JAX package;
- ``loads`` maps those names back to the port's classes, allows a few
  builtins a meta's ``objects`` may hold, and refuses any other global.

Fields, defaults and name helpers are the JAX package's, so either side
fills the fields later slices use (``index``, ``global_shape``,
``zero_degree``, ``mesh_axes``).
"""

import io
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Names of the on-host shared objects (namespaced per job by the socket
# dir, and per node rank so same-host multi-agent tests never collide).


def ckpt_factory_queue(node_rank: int) -> str:
    return f"ckpt_factory_n{node_rank}"


def ckpt_event_queue(node_rank: int) -> str:
    return f"ckpt_events_n{node_rank}"


def ckpt_meta_dict(node_rank: int) -> str:
    return f"ckpt_meta_n{node_rank}"


def ckpt_lock_name(node_rank: int, local_rank: int) -> str:
    return f"ckpt_lock_n{node_rank}_{local_rank}"


def ckpt_shm_name(job: str, node_rank: int, local_rank: int) -> str:
    return f"ckpt_{job}_n{node_rank}_rank{local_rank}"


@dataclass
class TensorMeta:
    """One array block staged in the shm buffer: its leaf path (a
    ``jax.tree_util.keystr`` string), byte offset and size, dtype name
    (``"bfloat16"``, ``"float32"``, ``"int8"``, ``"int32"``) and shape.
    ``global_shape``/``index`` locate a block of a sharded leaf (None for
    a whole leaf); ``persist`` marks the blocks this process writes to
    disk; ``crc`` is the legacy per-block checksum (None in shm metas)."""

    path: str
    offset: int
    nbytes: int
    dtype: str
    shape: Tuple[int, ...]
    global_shape: Optional[Tuple[int, ...]] = None
    index: Optional[Tuple[Tuple[int, int], ...]] = None
    persist: bool = True
    crc: Optional[int] = None


@dataclass
class StripeMeta:
    """One fixed-size stripe of a shard's persisted ``.bin``: its file
    range and crc; ``ref_step`` >= 0 when the bytes are unchanged since,
    and live in, that step's bin at the same offset."""

    offset: int = 0
    nbytes: int = 0
    crc: int = 0
    ref_step: int = -1


@dataclass
class ShardMeta:
    """Everything needed to rebuild one rank's state from its buffer."""

    step: int = -1
    shm_name: str = ""
    used_bytes: int = 0
    tensors: List[TensorMeta] = field(default_factory=list)
    # Non-array leaves: path -> picklable python object.
    objects: Dict[str, Any] = field(default_factory=dict)
    global_shard_id: int = 0
    global_shard_num: int = 1
    persist: bool = True
    layout_version: int = 0
    # Algorithm of the checksums ("" in shm metas).
    crc_algo: str = ""
    stripes: Optional[List[StripeMeta]] = None
    stripe_bytes: int = 0
    zero_degree: int = 0
    mesh_axes: Optional[Dict[str, int]] = None


@dataclass
class SaverRegistration:
    """Trainer → agent: create/configure the saver singleton."""

    class_name: str = "CommonDirCheckpointSaver"
    checkpoint_dir: str = ""
    local_shard_num: int = 1
    global_shard_num: int = 1
    node_rank: int = 0
    is_committer: bool = True
    keep_latest: int = 3


@dataclass
class SaveEvent:
    """Trainer → agent: persist the current memory snapshot of `step`
    ("save"), or shut the saver loop down ("stop")."""

    step: int = -1
    kind: str = "save"


# ------------------------------------------------------------ pickles

#: The module the JAX package's pickles name for these classes.
WIRE_MODULE = "dlrover_tpu.common.ckpt_meta"
_CLASSES = (TensorMeta, StripeMeta, ShardMeta, SaverRegistration, SaveEvent)
_WIRE_NAME = {cls: cls.__name__ for cls in _CLASSES}
_BY_NAME = {cls.__name__: cls for cls in _CLASSES}

# Python objects a meta's ``objects`` may hold beyond what pickle writes
# without naming a class (numbers, strings, tuples, lists, dicts, sets).
_BUILTINS = frozenset(("bytearray", "complex", "range", "slice"))


class _Pickler(pickle._Pickler):
    """The pure-Python pickler (the C one checks every class name by
    importing it), with the port's meta classes written under
    ``WIRE_MODULE``: the opcodes the C pickler writes for the JAX
    package's classes."""

    def save_global(self, obj, name=None):
        wire = _WIRE_NAME.get(obj)
        if wire is None:
            return super().save_global(obj, name)
        self.save(WIRE_MODULE)  # protocol >= 4, as ``dumps`` writes
        self.save(wire)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == WIRE_MODULE and name in _BY_NAME:
            return _BY_NAME[name]
        if module == "builtins" and name in _BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint metadata may not name {module}.{name}"
        )


def dumps(obj) -> bytes:
    """Pickle ``obj`` as the JAX package would pickle its twin."""
    out = io.BytesIO()
    _Pickler(out, protocol=pickle.DEFAULT_PROTOCOL).dump(obj)
    return out.getvalue()


def loads(data) -> Any:
    """Unpickle metadata written by either package into the port's
    classes; any global outside the metas' classes and a few builtins
    raises ``pickle.UnpicklingError``."""
    return _Unpickler(io.BytesIO(data)).load()

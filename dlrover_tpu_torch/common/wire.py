"""Pickles that name the JAX package's classes: the codec of the master's
wire and state files, and of the checkpoint metadata.

The master protocol (``common/rpc.py``) sends length-prefixed pickles,
the state store writes pickles into its snapshots and journal, and a
checkpoint's ``.meta`` files are pickles too. A pickle names each class
by module, so a JAX process writes
``dlrover_tpu.common.messages.JoinRendezvous``. A :class:`Codec` writes
the port's twins of such classes under the JAX package's module names,
and loads a pickle that names them into the port's classes without
importing the JAX package. So a port client talks to a JAX master, a JAX
client to a port master, and a state dir or a checkpoint written by
either package loads in the other.

A codec's ``loads`` refuses every global outside its classes and a few
builtins (``pickle.UnpicklingError``): the master decodes what any
process of the job sends it.

``dumps`` uses the pure-Python pickler, whose ``save_global`` writes the
JAX names itself: the C pickler checks every class it writes by
importing its module, and the JAX package is not importable here. The
bytes are those the C pickler writes for the JAX package's twin.
"""

import io
import pickle
from typing import Any, Dict, Iterable

from dlrover_tpu_torch.common import messages
from dlrover_tpu_torch.observability import events

# Python objects a value may hold beyond what pickle writes without
# naming a class (numbers, strings, tuples, lists, dicts, sets).
_BUILTINS = frozenset(("bytearray", "complex", "range", "slice"))

PROTOCOL = pickle.DEFAULT_PROTOCOL


class Codec:
    """Pickles of ``classes``, each named under the JAX module that
    ``modules`` maps its port module to; ``what`` names the data in the
    decoder's refusal."""

    def __init__(self, modules: Dict[str, str], classes: Iterable[type],
                 what: str):
        #: class -> (wire module, name), and the reverse.
        wire_name = {cls: (modules[cls.__module__], cls.__qualname__)
                     for cls in classes}
        by_wire_name = {wire: cls for cls, wire in wire_name.items()}

        class Pickler(pickle._Pickler):
            def save_global(self, obj, name=None):
                wire = wire_name.get(obj)
                if wire is None:
                    return super().save_global(obj, name)
                module, qualname = wire
                self.save(module)  # protocol >= 4, as ``dumps`` writes
                self.save(qualname)
                self.write(pickle.STACK_GLOBAL)
                self.memoize(obj)

        class Unpickler(pickle.Unpickler):
            def find_class(self, module, name):
                cls = by_wire_name.get((module, name))
                if cls is not None:
                    return cls
                if module == "builtins" and name in _BUILTINS:
                    return super().find_class(module, name)
                raise pickle.UnpicklingError(
                    f"{what} may not name {module}.{name}")

        self._pickler = Pickler
        self._unpickler = Unpickler

    def dumps(self, obj: Any) -> bytes:
        """``obj`` pickled as the JAX package pickles its twin."""
        out = io.BytesIO()
        self._pickler(out, protocol=PROTOCOL).dump(obj)
        return out.getvalue()

    def loads(self, data) -> Any:
        """Unpickle what either package wrote into the port's classes;
        any other global raises ``pickle.UnpicklingError``."""
        return self._unpickler(io.BytesIO(data)).load()


#: The port's module -> the module the JAX package's pickles name.
WIRE_MODULES = {
    messages.__name__: "dlrover_tpu.common.messages",
    events.__name__: "dlrover_tpu.observability.events",
}
_MASTER = Codec(
    WIRE_MODULES,
    [cls for cls in vars(messages).values()
     if isinstance(cls, type) and cls.__module__ == messages.__name__]
    + [events.JobEvent],
    "the master's wire",
)
dumps = _MASTER.dumps
loads = _MASTER.loads

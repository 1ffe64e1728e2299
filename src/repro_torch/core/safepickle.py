"""Restricted unpickling for peer-supplied payloads.

The port's own copy of the JAX package's ``core/safepickle.py``, with the
wire-name rule: a class of the port travels under the JAX package's module
name (``repro_torch.core.dht.PeerInfo`` is written as
``repro.core.dht.PeerInfo`` by :func:`wire_dumps`), and a wire name is
checked against the allowlist as written, then resolved to the port's own
class.  A torch peer and a JAX peer thus write the same bytes for the same
objects and read each other's, and reading never imports the JAX package.

Anything a Lattica node decodes off the swarm — checkpoint meta, CRDT
anti-entropy state, legacy pickled formats — comes from untrusted peers, and
an open ``pickle.loads`` there is an arbitrary-code-execution vector: the
``find_class`` hook resolves attacker-chosen globals, which ``__reduce__``
payloads then call.  :func:`restricted_loads` closes that hook: only an
explicit ``(module, name)`` allowlist resolves (empty by default, i.e. pure
primitives only), everything else raises ``ValueError``.

Builtin containers with dedicated pickle opcodes (dict/list/tuple/str/int/
float/bytes/bool/None) never touch ``find_class`` and always decode;
``set``/``frozenset`` do resolve through it, so allowlist
``("builtins", "set")`` etc. when a payload legitimately carries them.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, FrozenSet, Optional, Tuple

Allowed = FrozenSet[Tuple[str, str]]

#: the port's package, and the package whose module names go on the wire
_PORT, _WIRE = "repro_torch", "repro"


def _renamed(module: str, old: str, new: str) -> str:
    """``module`` with its top package ``old`` replaced by ``new``."""
    if module == old or module.startswith(old + "."):
        return new + module[len(old):]
    return module


class RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file: io.BytesIO, allowed: Allowed):
        super().__init__(file)
        self._allowed = allowed

    def find_class(self, module: str, name: str):  # noqa: D102
        if (module, name) in self._allowed:
            return super().find_class(_renamed(module, _WIRE, _PORT), name)
        raise pickle.UnpicklingError(
            f"refusing to resolve {module}.{name} in untrusted payload")


def restricted_loads(raw: bytes, allowed: Allowed = frozenset()) -> Any:
    """Unpickle ``raw`` resolving only allowlisted globals; raises
    ``ValueError`` on anything malformed or forbidden."""
    try:
        return RestrictedUnpickler(io.BytesIO(raw), allowed).load()
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 — malformed/forbidden pickle
        raise ValueError(f"undecodable pickled payload: {e}") from e


class _WirePickler(pickle._Pickler):
    """The pure-Python pickler, writing the port's globals under their
    wire names; every other global goes through the stock path."""

    def save_global(self, obj: Any, name: Optional[str] = None) -> None:
        module = getattr(obj, "__module__", None) or ""
        # interned as a module's own name is, so that a second global of
        # the same module takes the memo's BINGET exactly as ``pickle``'s
        wire = sys.intern(_renamed(module, _PORT, _WIRE))
        if wire == module:
            super().save_global(obj, name)
            return
        name = name or obj.__qualname__
        if self.proto >= 4:
            self.save(wire)
            self.save(name)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{wire}\n{name}\n".encode("utf-8"))
        self.memoize(obj)


def wire_dumps(obj: Any, protocol: Optional[int] = None) -> bytes:
    """``pickle.dumps(obj, protocol)`` with the port's classes written
    under the JAX package's module names: the bytes a JAX peer writes for
    the same object."""
    buf = io.BytesIO()
    _WirePickler(buf, protocol).dump(obj)
    return buf.getvalue()

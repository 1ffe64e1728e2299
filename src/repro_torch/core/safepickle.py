"""Restricted unpickling for peer-supplied payloads (the port's own copy
of the JAX package's ``core/safepickle.py``).

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
from typing import Any, FrozenSet, Tuple

Allowed = FrozenSet[Tuple[str, str]]


class RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file: io.BytesIO, allowed: Allowed):
        super().__init__(file)
        self._allowed = allowed

    def find_class(self, module: str, name: str):  # noqa: D102
        if (module, name) in self._allowed:
            return super().find_class(module, name)
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

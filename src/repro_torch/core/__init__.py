"""Framework-free pieces the port keeps its own copies of."""

from .device import resolve_device
from .simnet import Event, Process, Sim, SimError

__all__ = ["Event", "Process", "Sim", "SimError", "resolve_device"]

"""Resilience layer of the port: fault injection and thread watchdogs."""
from . import faults, watchdog
from .faults import configure, fault_point

__all__ = ["faults", "watchdog", "configure", "fault_point"]

"""Fault tolerance of serving: the deterministic fault injector and the
straggler monitor (port of the serving half of ``repro.ft``)."""

from .serving import (FAULT_KINDS, InjectedFault, PageCorruptionError,
                      ServingFaultInjector)
from .straggler import StragglerMonitor

__all__ = ["StragglerMonitor", "ServingFaultInjector", "InjectedFault",
           "PageCorruptionError", "FAULT_KINDS"]

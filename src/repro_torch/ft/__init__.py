"""Fault tolerance of serving: the deterministic fault injectors, the
straggler monitor and the replica heartbeat (port of the serving half of
``repro.ft``)."""

from .serving import (CRASH_KIND, FAULT_KINDS, FLEET_FAULT_KINDS,
                      FleetFaultInjector, InjectedCrash, InjectedFault,
                      PageCorruptionError, ServingFaultInjector)
from .straggler import ReplicaHeartbeat, StragglerMonitor

__all__ = ["StragglerMonitor", "ReplicaHeartbeat", "ServingFaultInjector",
           "FleetFaultInjector", "InjectedFault", "InjectedCrash",
           "PageCorruptionError", "FAULT_KINDS", "CRASH_KIND",
           "FLEET_FAULT_KINDS"]

"""Distribution layer (port of ``repro.dist``): the mesh context, the
sharding rules, the perf flags and the compressed gradient reduction, on
``torch.distributed`` DeviceMesh and DTensor.

Without a mesh every entry point is the identity (or replicated), so the
same model code runs in one process and under ``torchrun``.
"""

from .constrain import constrain, current_mesh, use_mesh
from .options import PerfFlags, flags, set_flags
from .sharding import (P, NamedSharding, batch_specs, cache_specs,
                       device_put, guard_spec, named, param_specs)

__all__ = [
    "constrain", "current_mesh", "use_mesh",
    "PerfFlags", "flags", "set_flags",
    "P", "NamedSharding", "batch_specs", "cache_specs", "device_put",
    "guard_spec", "named", "param_specs",
]

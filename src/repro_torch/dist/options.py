"""Global performance flags (port of ``repro.dist.options``).

Each flag gates one optimization of the sharded layout; defaults are all
off (the baseline).  Without a mesh only ``moe_einsum`` changes what runs
(the MoE dispatch's arithmetic); the others read the mesh.
"""

from __future__ import annotations

import dataclasses

__all__ = ["PerfFlags", "flags", "set_flags"]


@dataclasses.dataclass(frozen=True)
class PerfFlags:
    #: pin per-microbatch gradients and the accumulator to the parameters'
    #: placements (a reduce-scatter into sharded accumulators instead of a
    #: full-gradient all-reduce every microbatch)
    grad_specs: bool = False
    #: sequence-parallel attention when heads don't divide the model axis
    sp_attn: bool = False
    #: sequence-sharded dense KV cache for small-Hkv decode (serving)
    seq_kv: bool = False
    #: one-hot einsum MoE dispatch/combine instead of the scatter
    moe_einsum: bool = False
    #: batch-local MoE capacity buffer and one explicit all-gather of the
    #: expert outputs
    moe_local: bool = False

    @classmethod
    def all_on(cls) -> "PerfFlags":
        return cls(**{f.name: True for f in dataclasses.fields(cls)})


_FLAGS = PerfFlags()


def flags() -> PerfFlags:
    """The active flag set."""
    return _FLAGS


def set_flags(f: PerfFlags) -> None:
    global _FLAGS
    _FLAGS = f

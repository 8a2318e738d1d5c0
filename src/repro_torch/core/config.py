"""Frozen configuration object for the serving stack.

:class:`ServingConfig` consolidates the :class:`~repro_torch.serve.engine.ServingEngine`
/ ``Router`` constructor keywords. Both take ``config=`` as the documented
path while still accepting the legacy keywords, which are mapped through
``from_kwargs``.

The dataclass is frozen so a config can be shared across engines, stored on
the object that consumed it, and compared/hashed in tests without aliasing
surprises. (The simulator's ``SimConfig`` lives beside the simulator and is
not part of this package yet.)
"""

from __future__ import annotations

import dataclasses

__all__ = ["ServingConfig"]


def _check_known(cls: type, kw: dict) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kw) - known)
    if unknown:
        raise TypeError(f"{cls.__name__}: unknown knob(s) {unknown}; "
                        f"known: {sorted(known)}")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Shared knobs of the serving stack: engine geometry plus the router's
    park/pricing policy. One object configures both ``ServingEngine`` (which
    reads the geometry fields) and ``Router`` (which reads the policy
    fields), so the two layers can never disagree about the workload shape.

    ``resume_bias`` scales the priced resume cost against the measured
    migrate-and-re-prefill cost: > 1 makes the router migrate earlier,
    < 1 makes it cling to locality harder.
    """

    max_batch: int = 4
    max_seq: int = 128
    eos_id: int = -1
    idle_tier: str = "bb"
    allow_park: bool = True
    resume_bias: float = 1.0
    # None: follow REPRO_SANITIZE; True/False: force slot/placeholder
    # invariant checks at every engine/router transition
    sanitize: bool | None = None

    @classmethod
    def from_kwargs(cls, **kw) -> "ServingConfig":
        _check_known(cls, kw)
        return cls(**kw)

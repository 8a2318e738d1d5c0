"""Runtime invariant sanitizer: the serving-stack checks.

Cross-checks the serving engine's incremental slot bookkeeping against a
from-scratch rebuild of the same fact, raising a structured
:class:`SanitizerError` that names the first divergent entry.

Opt-in: set ``sanitize=True`` on :class:`~repro_torch.core.config.ServingConfig`,
or export ``REPRO_SANITIZE=1``.

Like the reference's sanitizer, this module never imports the serving stack;
callers hand their structures in. (The store and scheduler checks come with
the core slice of the port.)
"""

from __future__ import annotations

import os
from typing import Any

__all__ = ["SanitizerError", "env_enabled", "check_engine", "check_router"]


class SanitizerError(AssertionError):
    """An incremental structure diverged from its from-scratch rebuild.

    Carries the failing ``check``, the first divergent ``key`` (entries are
    visited in sorted order, so the report is deterministic), and the
    ``expected`` (rebuilt) vs ``actual`` (incremental) values."""

    def __init__(self, check: str, key: Any, expected: Any, actual: Any):
        self.check = check
        self.key = key
        self.expected = expected
        self.actual = actual
        super().__init__(
            f"sanitizer[{check}] divergent entry {key!r}: "
            f"rebuild says {expected!r}, incremental state says {actual!r}")


def env_enabled() -> bool:
    """``REPRO_SANITIZE`` truthiness — the process-wide opt-in used when a
    config object leaves ``sanitize`` unset."""
    return os.environ.get("REPRO_SANITIZE", "").strip().lower() \
        not in ("", "0", "false", "no", "off")


def _fail(check: str, key: Any, expected: Any, actual: Any) -> None:
    raise SanitizerError(check, key, expected, actual)


# ------------------------------------------------------------------- serving
def check_engine(engine: Any) -> None:
    """Slot bookkeeping: ``_slotted`` is exactly the slot-holding sessions,
    used and free slots partition ``range(max_batch)``, and every slotted
    session still has its KV placeholder in the store."""
    want_slotted = {sid: s for sid, s in engine.sessions.items()
                    if s.slot is not None}
    for sid in sorted(set(want_slotted) ^ set(engine._slotted)):
        _fail("engine-slots", f"session{sid}",
              sid in want_slotted, sid in engine._slotted)
    used = [s.slot for s in engine._slotted.values()]
    free = list(engine._free_slots)
    if len(set(used)) != len(used):
        dup = sorted(s for s in used if used.count(s) > 1)
        _fail("engine-slots", f"slot{dup[0]}", "one session per slot",
              f"{used.count(dup[0])} sessions share it")
    overlap = set(used) & set(free)
    if overlap:
        _fail("engine-slots", f"slot{sorted(overlap)[0]}",
              "slot is used xor free", "both used and free")
    want_all = set(range(engine.max_batch))
    got_all = set(used) | set(free)
    if got_all != want_all or len(free) != len(set(free)):
        _fail("engine-slots", "partition", sorted(want_all),
              f"used={sorted(used)} free={sorted(free)}")
    if engine.store is not None:
        from repro_torch.serve.engine import _cache_name
        for sid in sorted(engine._slotted):
            if not engine.store.exists(_cache_name(sid)):
                _fail("engine-slots", f"kv[{sid}]",
                      "placeholder replica for every slotted session",
                      "missing from store")


def check_router(router: Any) -> None:
    """Failover bookkeeping: a deferred (unhomed) session must not
    simultaneously be registered live on a surviving engine."""
    for sid in sorted(getattr(router, "_unhomed", {})):
        for node in sorted(router.engines):
            if sid in router.engines[node].sessions:
                _fail("router", f"session{sid}",
                      "unhomed sessions live nowhere",
                      f"registered on engine at node {node}")
    for node in sorted(router.engines):
        check_engine(router.engines[node])

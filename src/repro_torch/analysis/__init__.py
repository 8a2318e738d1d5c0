"""Runtime invariant checks of the port (the serving-stack part of the
reference's sanitizer; the workflow linter comes with a later slice)."""

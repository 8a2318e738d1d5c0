"""Cross-layer static analysis + runtime invariant sanitizer.

``repro_torch.analysis.lint`` proves workflow/config properties before
execution (races, capacity infeasibility, durability hazards, unsafe
write-around pins, cluster-config mistakes); ``repro_torch.analysis.sanitize``
cross-checks the runtime's incremental caches against from-scratch rebuilds
at checkpoints. ``python -m repro_torch.analysis`` lints every built-in
workload (the CI gate).
"""

from repro_torch.analysis.lint import (Finding, Rule, RULES, Severity,
                                       apply_allowlist, gate, lint,
                                       lint_graph, load_allowlist,
                                       safe_write_modes)
from repro_torch.analysis.sanitize import SanitizerError

__all__ = ["Finding", "Rule", "RULES", "Severity", "apply_allowlist",
           "gate", "lint", "lint_graph", "load_allowlist",
           "safe_write_modes", "SanitizerError"]

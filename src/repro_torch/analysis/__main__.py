"""``python -m repro_torch.analysis`` — lint every built-in workload.

Compiles each workload in ``repro_torch.core.workloads`` against ``HPC_CLUSTER``
and lints it with a representative ``SimConfig``, printing every finding
(suppressed ones with their allow-list reason). Exits non-zero when any
unsuppressed finding at WARNING or above remains — the CI gate.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.lint import (RULES, Severity, gate, lint,
                                 load_allowlist)
from repro_torch.core.config import SimConfig
from repro_torch.core.wfcompiler import HPC_CLUSTER, compile_workflow
from repro_torch.core.workloads import (fig2_workflow, mapreduce_workflow,
                                  montage_workflow, pipeline_chain_workflow,
                                  random_layered_workflow,
                                  serving_session_workflow,
                                  training_epoch_workflow)

BUILTINS = {
    "fig2": lambda: fig2_workflow(),
    "mapreduce": lambda: mapreduce_workflow(),
    "montage": lambda: montage_workflow(),
    "random_layered": lambda: random_layered_workflow(seed=0),
    "serving_session": lambda: serving_session_workflow(),
    "pipeline_chain": lambda: pipeline_chain_workflow(),
    "training_epoch": lambda: training_epoch_workflow(),
}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    ap.add_argument("--allowlist", default=None,
                    help="path to analysis_allowlist.json "
                         "(default: repo root)")
    ap.add_argument("--workload", action="append", choices=sorted(BUILTINS),
                    help="lint only these built-ins (default: all)")
    ap.add_argument("--fail-on", default="WARNING",
                    choices=[s.name for s in Severity],
                    help="minimum severity that fails the gate")
    args = ap.parse_args(argv)

    allowlist = load_allowlist(args.allowlist)
    threshold = Severity[args.fail_on]
    config = SimConfig(n_nodes=8, hw=HPC_CLUSTER)
    names = args.workload or sorted(BUILTINS)
    n_findings = 0
    failing = []
    for name in names:
        wf = compile_workflow(BUILTINS[name](), HPC_CLUSTER)
        findings = lint(wf, config=config, name=name, allowlist=allowlist)
        n_findings += len(findings)
        for f in findings:
            print(f)
        failing.extend(gate(findings, threshold))
    print(f"{len(names)} workload(s) linted, {len(RULES)} rule(s), "
          f"{n_findings} finding(s), "
          f"{len(failing)} unsuppressed >= {threshold}")
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())

"""Hint annotations — the paper's Swift/T ``@`` language extensions.

The paper (§B, "Hint-Assist Workflow Compiler") adds four annotations to the
Swift/T language so the compiler can attach "rich" metadata to the task DAG:

  ``@size``                 size of an existing (external-input) file
  ``@task``                 key task parameters (process count)
  ``@compute-complexity``   computation cost as a function of input size
                            (e.g. ``@compute-complexity=@input`` == linear)
  ``@input-output-ratio``   output size as a function of input size

We reproduce these as Python-level hints. ``@compute-complexity`` is expressed
as a :class:`Complexity` — either one of the named growth laws from the paper's
examples (``const``/``linear``/``nlogn``/``quadratic``) scaled by a
``flops_per_byte`` coefficient, or an arbitrary callable ``bytes -> flops``.

Nothing in this module touches torch: hints are pure static metadata consumed by
:mod:`repro_torch.core.wfcompiler`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Union

__all__ = [
    "Complexity",
    "TaskHints",
    "task",
    "size_hint",
    "CONST",
    "LINEAR",
    "NLOGN",
    "QUADRATIC",
]


@dataclasses.dataclass(frozen=True)
class Complexity:
    """``@compute-complexity`` — estimated FLOPs as a function of input bytes.

    ``law`` is one of ``const|linear|nlogn|quadratic`` or ``custom`` (then
    ``fn`` must be given). ``flops_per_byte`` scales the law: e.g. an FFT-ish
    task would be ``Complexity("nlogn", flops_per_byte=5.0)``.
    """

    law: str = "linear"
    flops_per_byte: float = 1.0
    fn: Callable[[float], float] | None = None

    def flops(self, input_bytes: float) -> float:
        b = max(float(input_bytes), 0.0)
        if self.fn is not None:
            return float(self.fn(b))
        if self.law == "const":
            return self.flops_per_byte
        if self.law == "linear":
            return self.flops_per_byte * b
        if self.law == "nlogn":
            return self.flops_per_byte * b * math.log2(b + 2.0)
        if self.law == "quadratic":
            return self.flops_per_byte * b * b
        raise ValueError(f"unknown complexity law {self.law!r}")


CONST = Complexity("const")
LINEAR = Complexity("linear")
NLOGN = Complexity("nlogn")
QUADRATIC = Complexity("quadratic")

ComplexityLike = Union[Complexity, str, float, Callable[[float], float]]


def _as_complexity(c: ComplexityLike) -> Complexity:
    if isinstance(c, Complexity):
        return c
    if isinstance(c, str):
        return Complexity(c)
    if callable(c):
        return Complexity("custom", fn=c)
    # a bare number means "linear with this flops/byte coefficient"
    return Complexity("linear", flops_per_byte=float(c))


@dataclasses.dataclass(frozen=True)
class TaskHints:
    """The paper's ``@task`` / ``@compute-complexity`` / ``@input-output-ratio``
    bundle attached to one task.

    ``io_ratio`` maps *output name -> output_bytes / total_input_bytes*; a
    single float applies to every output. ``procs`` is the paper's ``@task``
    process-count hint. ``est_seconds`` lets the runtime override the static
    estimate once a task has actually run (the compiler estimate is used until
    then — exactly the paper's compiler/runtime split).
    """

    procs: int = 1
    compute: Complexity = LINEAR
    io_ratio: Union[float, Mapping[str, float]] = 1.0
    est_seconds: float | None = None

    def ratio_for(self, output_name: str) -> float:
        if isinstance(self.io_ratio, Mapping):
            return float(self.io_ratio.get(output_name, 1.0))
        return float(self.io_ratio)


def task(
    *,
    procs: int = 1,
    compute: ComplexityLike = LINEAR,
    io_ratio: Union[float, Mapping[str, float]] = 1.0,
    est_seconds: float | None = None,
) -> TaskHints:
    """Build a :class:`TaskHints` — spelled like the paper's ``@task(...)``.

    Example (paper Fig. 2 style)::

        hints = task(procs=4, compute="linear", io_ratio=0.25)
    """
    return TaskHints(
        procs=int(procs),
        compute=_as_complexity(compute),
        io_ratio=io_ratio,
        est_seconds=est_seconds,
    )


def size_hint(num_bytes: float) -> float:
    """``@size`` — size of an existing external input, in bytes."""
    if num_bytes < 0:
        raise ValueError("@size must be non-negative")
    return float(num_bytes)

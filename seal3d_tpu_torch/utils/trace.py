"""Named ranges of the port in a torch.profiler trace.

Every range of the package opens through `span(name)`: a
`record_function` while a profiler records, and a shared null context
otherwise, since `record_function` costs ~10 us a range even with no
profiler on. The names' prefixes (`step.`, `render.`, `tensorf.`,
`edit.`, `seal.`, `pretrain.`) say which stage of the program a range
belongs to.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` as a range while a
    torch.profiler (or the autograd profiler) is on, and does nothing
    otherwise."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _OFF

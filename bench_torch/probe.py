"""Shapes of a kernel's launches, for its roofline reader.

The trace gives each launch's device time and the kernel's name, not the
shapes.  A probe wraps the function through which the program's
operators call a kernel wrapper (a module attribute, such as
``rails_tpu_torch.sparse.formats.dia_spmm``) and records the work of
each call, and whether a CUDA graph was being captured.  It is installed
in traced runs only, before the set-up, so it also sees the calls that
the engine captures; a replay launches again only what was captured.
Where the attribute is not there, the probe records nothing and the
reader finds nothing to read.
"""

from __future__ import annotations

import importlib

import torch


class Probe:
    def __init__(self, module: str, name: str, work):
        """``work(args) -> (bytes, operations, dtype name)`` of one call."""
        self.module, self.name, self.work = module, name, work
        self.calls = []        # (bytes, operations, dtype, capturing, tag)
        self.tag = None        # set by the harness: "window" inside it
        self.installed = False
        self._orig = None

    def install(self) -> None:
        try:
            mod = importlib.import_module(self.module)
        except ImportError:
            return
        orig = getattr(mod, self.name, None)
        if orig is None:
            return
        probe = self

        def recorded(*args, **kwargs):
            nbytes, ops, dtype = probe.work(*args)
            capturing = torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing()
            probe.calls.append((nbytes, ops, dtype, capturing, probe.tag))
            return orig(*args, **kwargs)

        setattr(mod, self.name, recorded)
        self._orig, self._mod, self.installed = orig, mod, True

    def remove(self) -> None:
        if self.installed:
            setattr(self._mod, self.name, self._orig)
            self.installed = False

    def works_in(self, tag, launches: int):
        """The (bytes, operations, dtype) of ``launches`` launches traced
        under ``tag``: the eager calls recorded there, and for the rest -
        replays of captured calls - the captured work, where every
        captured call had the same work; None where that does not
        hold."""
        eager = [c[:3] for c in self.calls if c[4] == tag and not c[3]]
        rest = launches - len(eager)
        if rest < 0:
            return None
        if rest == 0:
            return eager
        captured = {c[:3] for c in self.calls if c[3]}
        if len(captured) != 1:
            return None
        return eager + [next(iter(captured))] * rest

"""Spans and the host-lead counter: the one place the port's profiler ranges
and its per-unit host lead come from.

`span(name)` is a profiler range that costs nothing but a check when no
profiler runs (0.7-0.9 us a span on an H100 machine's host, where an
unprofiled `record_function` costs 10-13 us): while torch.profiler records (`torch.autograd.
_profiler_enabled()`) it opens `torch.profiler.record_function(name)`, so the
range lands in the profiler's Chrome trace on the device's clock and the
profiler adds its device-side range; otherwise it returns a shared do-nothing
context. Used as a decorator (`@span(name)`, applied when the module is
imported) it makes that choice at each call. Spans stay in the profiler's
memory; whoever exports the trace writes them (the Trainer's
`profile_steps`, train_profile.py, tools/profile_forward.py, a benchmark).
The spans: "train_step.forward", ".backward" and ".optimizer" (utils/
trainer.py); "model.norm" (models/common/layers.apply_norm), "model.filter"
(the SFNO's SpectralFilterLayer, the AFNO v2 block's filter) and "model.mlp"
(the block MLPs of both).

The host lead: a unit is one `Trainer.train_step` (loop "train") or one
`Inferencer.lite_step` (loop "serve"). `mark(loop, device)` at a unit's start
records a timing CUDA event on the device's current stream beside the host's
clock; once the event has completed (a non-blocking query at a later mark, or
`settle(loop)` after a synchronize) the unit's offset is the event's device
time less the host time, both from the run's first unit. The smallest offset
of the run is that of a unit the card was waiting for, so a unit's lead, its
offset less that smallest, is how long the card took to reach work the host
had enqueued: near 0 the host sets the pace, near a unit's time or more the
card does. `leads(loop)` gives the last KEEP leads in ms; `reset()` starts
new runs. On the CPU nothing is recorded. The cost is a host clock read and
an event record a unit, and a query and an elapsed time once the event has
completed (~23 us a unit on an H100 machine's host), and nothing a launch.
"""

import collections
import functools
import math
import time

import torch
from torch.profiler import record_function

# leads kept a loop
KEEP = 4096
# marks waiting for their event at most; a unit beyond it goes unmarked
PENDING = 64


class _Idle:
    """A span while no profiler runs: enters nothing; as a decorator it
    opens span(name) around each call."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


_IDLE = {}


def span(name):
    """A profiler range named `name` while a profiler records, else the
    shared do-nothing context of that name."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    idle = _IDLE.get(name)
    if idle is None:
        idle = _IDLE[name] = _Idle(name)
    return idle


class _Loop:
    """One loop's run: its first (event, host ns), the marks whose events
    are pending, the events free for reuse, the offsets in ms."""

    def __init__(self, device):
        self.device = device
        self.first = None
        self.pending = collections.deque()
        self.free = []
        self.offsets = collections.deque(maxlen=KEEP)
        self.least = math.inf

    def mark(self):
        self.settle()
        if len(self.pending) >= PENDING:
            return
        event = self.free.pop() if self.free else torch.cuda.Event(enable_timing=True)
        now = time.perf_counter_ns()
        event.record(torch.cuda.current_stream(self.device))
        if self.first is None:
            self.first = (event, now)
        self.pending.append((event, now))

    def settle(self):
        while self.pending and self.pending[0][0].query():
            event, now = self.pending.popleft()
            first, t0 = self.first
            offset = first.elapsed_time(event) - (now - t0) / 1e6
            self.offsets.append(offset)
            self.least = min(self.least, offset)
            if event is not first:
                self.free.append(event)


_LOOPS = {}


def mark(loop, device):
    """The start of a unit of `loop` on `device` (nothing off CUDA)."""
    if device.type != "cuda":
        return
    state = _LOOPS.get(loop)
    if state is None or state.device != device:
        state = _LOOPS[loop] = _Loop(device)
    state.mark()


def settle(loop):
    """Take the offsets of the units of `loop` whose events have completed."""
    state = _LOOPS.get(loop)
    if state is not None:
        state.settle()


def leads(loop):
    """The host leads of `loop`'s last KEEP settled units, ms, oldest first."""
    state = _LOOPS.get(loop)
    if state is None:
        return []
    return [offset - state.least for offset in state.offsets]


def reset():
    """Forget every loop's run."""
    _LOOPS.clear()

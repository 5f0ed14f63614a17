"""What the kernel wrappers need to be captured in a CUDA graph
(gtax_torch.sampling.graphs): device constants held for good, buffers a
capture owns, and launch counts recorded per capture.

A graph bakes in the address of every tensor its launches read, so a
constant that was cached once must never be freed while a graph may hold
it: `held` keeps every constant for good (the keys are few: the masks of a
5-frame window, the biases of an attention's few shapes). Nor may one be
made inside a capture: its values would exist only when that graph runs,
and an eager caller would read it unwritten. A key first asked for inside a
capture raises; the capture's warm-up frame, run eagerly just before it,
asks for every key the capture will.

A buffer that launches read and write from call to call (the persistent
fp32 GEMM's tile counters) is `owned`: inside a `Scope` (a capture and its
warm-up, on this thread) the scope's own, which its graph keeps, so that
no other launch, eager or replayed, shares it with that graph's replays;
outside one, held for good as a constant is.

`launched(wrapper)` counts one launch of a kernel wrapper: in its
`.launches`, or, while this thread records a capture, in the scope's
`launches`, which the graph adds back at each replay. Each thread has its
own scope, so a capture in one thread (VideoGenerator.prewarm's) takes
nothing from the counts of launches another makes meanwhile.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_HELD = {}
_LOCAL = threading.local()


def capturing(device) -> bool:
    """Whether the current stream of `device` is being captured."""
    return (torch.device(device).type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def _get(table, key, device, make):
    device = torch.device(device)
    t = table.get((key, device))
    if t is None:
        if capturing(device):
            raise RuntimeError(
                f"device constant {key!r} first asked for inside a CUDA "
                "graph capture: run the frame eagerly first (the capture's "
                "warm-up does)")
        with torch.inference_mode(False):
            t = make(device)
            if t.is_inference():
                t = t.clone()
        t = table.setdefault((key, device), t)
    return t


def held(key, device, make) -> torch.Tensor:
    """The constant `make(device)` gives for `key` on `device`, made on the
    first call and kept; a first call inside a stream capture raises. It is
    a normal tensor even when first asked for under inference mode (a
    generate's), so that autograd (a training step's) may save it."""
    return _get(_HELD, key, device, make)


class Scope:
    """A capture and its warm-up on one thread: `buffers`, what `owned`
    made in it (the graph keeps them), and `launches`, wrapper -> the
    launches recorded while `recording`."""

    def __init__(self):
        self.buffers, self.launches, self.recording = {}, {}, False


@contextlib.contextmanager
def scope():
    """Enter a Scope on this thread (one at a time) and yield it."""
    if getattr(_LOCAL, "scope", None) is not None:
        raise RuntimeError("a capture scope is open on this thread already")
    _LOCAL.scope = Scope()
    try:
        yield _LOCAL.scope
    finally:
        _LOCAL.scope = None


def owned(key, device, make) -> torch.Tensor:
    """The buffer `make(device)` gives for `key`: the open Scope's own on
    this thread, else held for good; made on the first call, never inside a
    capture."""
    sc = getattr(_LOCAL, "scope", None)
    return _get(_HELD if sc is None else sc.buffers, key, device, make)


def launched(wrapper) -> None:
    """Count one launch of `wrapper`'s kernel: in `wrapper.launches`, or in
    the open Scope's record while it records a capture."""
    sc = getattr(_LOCAL, "scope", None)
    if sc is not None and sc.recording:
        sc.launches[wrapper] = sc.launches.get(wrapper, 0) + 1
    else:
        wrapper.launches += 1

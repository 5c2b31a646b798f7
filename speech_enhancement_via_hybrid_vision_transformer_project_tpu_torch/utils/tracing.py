"""The port's recorder of host spans and counters: one per process.

``span(name, id=None)`` times a stretch of host work::

    with tracing.span("enhance.pad"):
        ...

Off, which is the default, it returns one shared no-op context: no clock is
read and nothing is allocated. On (``enable()``), each span is kept as a
``Span`` on ``time.perf_counter`` (the clock a benchmark's own host spans
use) in a ring of ``CAPACITY`` spans, the oldest dropped first, so a server
left running does not grow; ``spans()`` reads them out. A span's parent is
the span open around it on its thread, and a span given no id takes its
parent's. ``record`` keeps an interval timed elsewhere, such as a request's
wait from one thread's ``submit`` to another's taking it. A span never
synchronizes the device and never reads a tensor: it times what the host
does, enqueueing included, and the device's side comes from a device trace.
``enable(profiler_ranges=True)`` also opens a
``torch.profiler.record_function`` of each span's name, so that a profiler's
trace carries the same names.

``count(name, n)`` adds to a named counter: plain ints, always on.

The port's spans (children indented under their parent) and counters:

* ``training/trainer.py``: ``train.step`` (id: the ``train.steps`` count)
  with ``train.featurize``, ``train.forward`` (model and loss),
  ``train.backward`` (``autograd.grad`` and the zero fill), ``train.norm``
  (the clip's global norm), ``train.sync`` (the non-finite check: the host
  waiting for the device), ``train.optimizer`` (``Optimizer.step``, clip
  included); ``train.h2d`` (``batch_to_device``). Counter
  ``train.steps``.
* ``training/optimizer.py``: counters ``optimizer.fused_steps`` (steps
  through the ``adam_update`` kernel) and ``optimizer.loop_steps`` (steps
  through a per-tensor loop: CPU tensors, SGD).
* ``inference/enhancer.py`` (id: the ``enhance.batches`` count):
  ``enhance.dispatch`` with ``enhance.pad`` (padding, PCM16 conversion),
  ``enhance.stage`` (pinned copy, H2D enqueue), ``enhance.launch`` (the
  core's enqueue), ``enhance.d2h`` (pinned output, copy enqueue, event);
  ``enhance.result`` with ``enhance.wait`` (the event) and
  ``enhance.unpack``. Counters ``enhance.batches``,
  ``enhance.true_samples``, ``enhance.padded_samples`` (bucket padding is
  the share of padded samples that are not true ones).
* ``models/cmgan.py``, inside ``enhance.launch``: ``cmgan.encoder``,
  ``cmgan.tscb`` (id: the block, 1-4) and ``cmgan.decoders``, each the
  host's enqueue of that part. Counters ``cmgan.true_frames`` and
  ``cmgan.padded_frames`` (a batch's valid frames and all of its frames,
  where the caller gives the valid count from the host), and
  ``cmgan.add_norm_calls`` (the conformers' sublayer boundaries, one
  ``add_layer_norm`` call each: 5 a conformer block, 40 a forward) and
  ``cmgan.instance_norm_calls`` (the masked InstanceNorms with their
  PReLUs, one ``instance_norm_prelu`` call each: 16 a forward).
* ``models/semamba.py``, inside ``enhance.launch``: ``semamba.encoder``,
  ``semamba.tfmamba`` (id: the block, 1-4) and ``semamba.decoders``, each the
  host's enqueue of that part. Counters ``semamba.true_frames`` and
  ``semamba.padded_frames`` (as CMGAN's), ``semamba.scan_calls`` (the
  selective scans, one ``selective_scan`` call each: 16 a forward),
  ``semamba.scan_tokens`` (the steps those calls run, summed over their
  sequences, where the host knows the valid frames) and
  ``semamba.instance_norm_calls`` (16 a forward).
* ``ops/cuda_attention.py``: counters ``attention.relpos_calls`` (K2r's op
  calls) and ``attention.relpos_pairs`` (the query-key pairs over kept keys
  given to it).
* ``inference/server.py`` (id: the request's): ``serve.parse``,
  ``serve.queue_wait`` (``submit`` to the batcher taking the request),
  ``serve.collect``, ``serve.process`` (one length bucket's batch),
  ``serve.reply``.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

CAPACITY = 1 << 16


class Span(NamedTuple):
    name: str
    start: float
    end: float
    parent: int  # the serial of the span open around it on its thread, or -1
    id: Optional[int]
    thread: int
    serial: int


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()

_on = False
_range = None  # torch.profiler.record_function in profiler mode
_ring: deque = deque(maxlen=CAPACITY)
_serials = itertools.count()
_local = threading.local()
_counts: Dict[str, int] = {}
_counts_lock = threading.Lock()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _OpenSpan:
    __slots__ = ("name", "id", "start", "parent", "serial", "range")

    def __init__(self, name: str, id: Optional[int]):
        self.name = name
        self.id = id

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent = top.serial
            if self.id is None:
                self.id = top.id
        else:
            self.parent = -1
        self.serial = next(_serials)
        stack.append(self)
        self.range = _range(self.name).__enter__() if _range is not None else None
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        _ring.append(Span(self.name, self.start, end, self.parent, self.id,
                          threading.get_ident(), self.serial))
        return False


def span(name: str, id: Optional[int] = None):
    """A context that records ``name`` around its body while the recorder
    is on; the shared no-op ``NO_SPAN`` while it is off."""
    if not _on:
        return NO_SPAN
    return _OpenSpan(name, id)


def record(name: str, start: float, end: float, id: Optional[int] = None) -> None:
    """Keep an interval timed on ``time.perf_counter`` elsewhere (no parent)
    while the recorder is on."""
    if _on:
        _ring.append(Span(name, start, end, -1, id, threading.get_ident(), next(_serials)))


def enable(profiler_ranges: bool = False) -> None:
    """Turn the recorder on; with ``profiler_ranges`` each span also opens
    a ``torch.profiler.record_function``."""
    global _on, _range
    if profiler_ranges:
        from torch.profiler import record_function

        _range = record_function
    else:
        _range = None
    _on = True


def disable() -> None:
    """Turn the recorder off; what it kept stays readable."""
    global _on, _range
    _on, _range = False, None


def spans() -> List[Span]:
    """The kept spans, in the order they ended."""
    return list(_ring)


def clear() -> None:
    """Drop the kept spans."""
    _ring.clear()


def self_seconds(records: List[Span]) -> List[float]:
    """Each span's seconds less its children's among ``records``."""
    children: Dict[int, float] = {}
    for s in records:
        if s.parent >= 0:
            children[s.parent] = children.get(s.parent, 0.0) + (s.end - s.start)
    return [s.end - s.start - children.get(s.serial, 0.0) for s in records]


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to counter ``name``; returns its new value."""
    with _counts_lock:
        value = _counts[name] = _counts.get(name, 0) + n
    return value


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _counts_lock:
        return dict(_counts)

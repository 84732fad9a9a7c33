"""Tracing (counterpart of ``ipoke_tpu/utils/profiling.py``): program spans
on the profiler's timeline, process-wide counters, and a ``torch.profiler``
trace exported as a Chrome trace.

Spans are off by default, and ``span(name)`` then returns one shared null
context: a module flag is all it reads.  ``spans()`` switches them on for a
block (for every thread of the process); each ``span`` is then a
``torch.profiler.record_function`` range, which a profiler session records
on the same timeline as the kernels, copies and sets launched inside it.
``trace(log_dir)`` switches them on for its block.  Counters are always on.

Spans at the port's layer boundaries (a span nests in the one open around
it on the calling thread):

  second_stage.forward_sample  the whole sampling call
  second_stage.embed_cond      the conditioner and poke-embedder towers
  flow.reverse                 the whole flow inverse
  flow.level.<k>               each level of a multi-scale inverse, k in forward order
  first_stage.decode           the ConvGRU and SPADE frame loop
  gan.step                     the whole stage-1 GAN train step
  gan.plan                     its key split and crop plan (drawn on the host)
  gan.gen_forward              its no-grad generator forward and crops
  gan.dt, gan.ds, gan.gen      each net's loss, gradient, update and spectral refresh

Counters: ``mcf.k1_launches`` and ``mcf.k2_launches``, the MCF inverse
kernels' launches (``ops/cuda``), and ``second_stage.calls``, the sampling
calls (``models/second_stage.forward_sample``).
"""
from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_on = False
_NULL = contextlib.nullcontext()
_counts = {}


def span(name):
    """A context naming the block ``name`` on the profiler's timeline while
    spans are on; the shared null context while they are off, and while
    ``torch.compile`` or ``torch.export`` traces (no span enters a graph)."""
    if not _on or torch.compiler.is_compiling():
        return _NULL
    return record_function(name)


@contextlib.contextmanager
def spans(on=True):
    """Spans on (or off) for the block; the previous setting after it."""
    global _on
    before, _on = _on, bool(on)
    try:
        yield
    finally:
        _on = before


def count(name, n=1):
    """Add ``n`` to the process-wide counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts():
    """A copy of every counter: difference two snapshots for the counts
    between them."""
    return dict(_counts)


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Profile the block with ``torch.profiler`` (the CPU, and the card when
    CUDA is available), spans on, and write ``<log_dir>/trace.json`` (open it
    in Perfetto or chrome://tracing: the spans sit over the kernels they
    launched).  Yields the profiler, or None when not ``enabled``."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, spans():
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

"""Dynamic batcher: the core of the serving path (counterpart of
``ipoke_tpu/serve/batcher.py``): the live model, or a loaded serving artifact
(``from_artifact``, ``serve/artifact.py``).

* **A ladder of batch buckets.**  Requests are padded up to 1, 2, 4, ...
  ``max_batch`` examples, as in the JAX package, where each bucket is one
  compiled executable.  Here it keeps the batch sizes the kernels and cuDNN
  see to a few, and ``warmup`` runs each once before traffic.

* **Batch-composition invariance.**  Every op of ``forward_sample`` is per
  example, and each request's Gaussian z is drawn from its own seed, the
  JAX package's draw ``jax.random.normal(PRNGKey(seed), z_shape)`` reproduced
  by ``utils/prng``.  So a request's video does not depend on which other
  requests share its batch, and equals the JAX server's for the same
  ``(x0, poke, seed)``.  On the card cuDNN may pick another algorithm per
  batch size, so alone and batched agree within a tolerance, not bitwise.

* **Latency/throughput knob.**  The worker collects requests until either
  ``max_batch`` are waiting or the oldest has waited ``max_delay_ms``.

* One worker thread owns the device: it sets the CUDA current device (a
  per-thread setting), uploads x0 and poke once per batch, and brings the
  video back with one ``.cpu()``, which is the batch's synchronisation.
"""
from __future__ import annotations

import queue
import sys
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np
import torch

from ipoke_tpu_torch.flows import transformer
from ipoke_tpu_torch.models import second_stage
from ipoke_tpu_torch.utils import prng

# How far a request's video served alone may lie from the same request
# served in a shared batch, on the card (f32 decode, TF32 off; max abs on the
# [-1, 1] scale): chip_smoke.py's serve check measured 2.4e-5 on an H100 at
# iper_128 (bucket 1 against bucket 4, flow output gains 0.02); 2e-4 leaves
# room for cuDNN's choice of algorithm on another card or library version.
CUDA_BATCH_TOL = 2e-4


@dataclass
class BatcherConfig:
    max_batch: int = 8
    max_delay_ms: float = 30.0
    length: Optional[int] = None    # frames to unroll (None: spec max - 1)
    # wire_u8: quantise videos to uint8 pixels on the device ([-1,1] ->
    # 0..255, the mp4/eval writers' quantisation): a quarter of the
    # device-to-host bytes, and no per-request quantise on the host.
    wire_u8: bool = False


@dataclass
class Stats:
    requests: int = 0
    batches: int = 0
    batch_hist: dict = field(default_factory=dict)
    total_wait_s: float = 0.0
    total_exec_s: float = 0.0

    def snapshot(self):
        return {
            "requests": self.requests,
            "batches": self.batches,
            "batch_size_histogram": dict(self.batch_hist),
            "mean_wait_ms": (1000 * self.total_wait_s / self.requests
                             if self.requests else 0.0),
            "mean_batch_exec_ms": (1000 * self.total_exec_s / self.batches
                                   if self.batches else 0.0),
        }


class _Request:
    __slots__ = ("x0", "poke", "seed", "t_enqueue", "event", "result", "error")

    def __init__(self, x0, poke, seed):
        self.x0 = x0
        self.poke = poke
        self.seed = seed
        self.t_enqueue = time.monotonic()
        self.event = threading.Event()
        self.result = None
        self.error = None


def _first_tensor(tree):
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


class SampleBatcher:
    """Batches (x0, poke, seed) requests through ``forward_sample``.

    ``params`` are the port's tensors, already on the device the batcher
    runs on (the card, or the CPU where the caller put them there).
    ``submit`` is thread-safe and blocks until the request's video is ready;
    use ``submit_async`` to get a handle instead.
    """

    def __init__(self, params, spec, cfg: BatcherConfig = BatcherConfig(), _artifact=None):
        self.params = params
        self.spec = spec
        self.cfg = cfg
        self.device = _first_tensor(params).device
        self.stats = Stats()
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self._artifact = _artifact
        if _artifact is not None:
            if cfg.wire_u8 and _artifact.manifest.get("wire", "f32") != "u8":
                raise ValueError(
                    "wire_u8 needs an artifact exported with --wire-u8 (its output "
                    "dtype is fixed at export) or the live-model path")
            # only the artifact's exported buckets exist
            self._buckets = [b for b in _artifact.buckets if b <= cfg.max_batch]
            if not self._buckets:
                raise ValueError(f"no artifact bucket <= max_batch={cfg.max_batch} "
                                 f"(exported: {_artifact.buckets})")
            if cfg.max_batch > self._buckets[-1]:
                # never gather more requests than the largest runnable bucket
                self.cfg = cfg = replace(cfg, max_batch=self._buckets[-1])
            if cfg.length is not None and cfg.length != _artifact.length:
                raise ValueError(
                    f"length={cfg.length} requested but the artifact was exported with "
                    f"length={_artifact.length}; re-export with --length to change it")
            self._length = _artifact.length
            self._x0_shape = _artifact.x0_shape
            self._poke_shape = _artifact.poke_shape
            self._z_shape = _artifact.z_shape
        else:
            self._buckets = self._bucket_ladder(cfg.max_batch)
            self._length = cfg.length or (spec.first_stage.max_frames - 1)
            s = spec.first_stage.spatial_size
            self._x0_shape = (s, s, 3)
            self._poke_shape = (s, s, 2)
            self._z_shape = tuple(transformer.reverse_input_shape(
                spec.flow, 1, spec.latent_size, spec.flow_in_channels)[1:])
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    @classmethod
    def from_artifact(cls, artifact, cfg: BatcherConfig = None):
        """Batcher over a loaded serving artifact (``serve/artifact.py``'s
        ``LoadedSampler``): no model code runs, the params come from the
        artifact, the buckets are its exported ones up to ``max_batch``."""
        cfg = cfg or BatcherConfig(max_batch=max(artifact.buckets))
        return cls(artifact.params, None, cfg, _artifact=artifact)

    # -- public API --------------------------------------------------------

    @property
    def buckets(self):
        """The batch sizes requests are padded up to."""
        return list(self._buckets)

    def submit(self, x0, poke, seed: int = 0, timeout: Optional[float] = None):
        req = self.submit_async(x0, poke, seed)
        if not req.event.wait(timeout):
            raise TimeoutError("sample request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def submit_async(self, x0, poke, seed: int = 0) -> _Request:
        x0 = np.asarray(x0, np.float32)
        poke = np.asarray(poke, np.float32)
        if x0.shape != self._x0_shape or poke.shape != self._poke_shape:
            raise ValueError(
                f"expected x0 {self._x0_shape} / poke {self._poke_shape}, "
                f"got {x0.shape} / {poke.shape}"
            )
        # seeds live in a 32-bit space: an int64 client seed maps to the
        # documented draw PRNGKey(seed & 0xFFFFFFFF)
        req = _Request(x0, poke, int(seed) & 0xFFFFFFFF)
        self._q.put(req)
        return req

    def warmup(self, buckets=None):
        """Run each of the given buckets (default: all) once, on zeros,
        before serving traffic."""
        for b in buckets or self._buckets:
            zero = np.zeros((b,) + self._x0_shape, np.float32)
            zerop = np.zeros((b,) + self._poke_shape, np.float32)
            self._run(zero, zerop, list(range(b)))

    def close(self):
        self._stop.set()
        self._worker.join(timeout=10)

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _bucket_ladder(max_batch):
        b, ladder = 1, []
        while b < max_batch:
            ladder.append(b)
            b *= 2
        ladder.append(max_batch)
        return ladder

    def _bucket_for(self, n):
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _run(self, x0, poke, seeds):
        """Videos of one padded batch as a host array: x0/poke go up once,
        z is drawn on the device, the video comes back by one ``.cpu()``."""
        dev = self.device
        batch = {"images": torch.from_numpy(x0).to(dev)[:, None],
                 "poke": torch.from_numpy(poke).to(dev)}
        z = prng.normal_for_seeds(seeds, self._z_shape, dev)
        if self._artifact is not None:
            v = self._artifact.run(self.params, batch["images"][:, 0], batch["poke"], z)
        else:
            v = second_stage.forward_sample(self.params, self.spec, batch, length=self._length,
                                            add_first_frame=True, z=z)[0]
        if self.cfg.wire_u8 and v.dtype != torch.uint8:
            # float -> uint8 truncates, as JAX's astype does
            v = ((v + 1.0) * 127.5).clamp_(0.0, 255.0).to(torch.uint8)
        return v.cpu().numpy()

    def _collect(self):
        """Block for the first request, drain the backlog, then fill until
        max_batch or the oldest request has waited max_delay_ms.

        Draining the backlog before consulting the delay window matters:
        under sustained load the oldest request has usually already outwaited
        max_delay in the queue, and a pure waiting policy would then dispatch
        batches of 1 exactly when batching matters most."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        reqs = [first]
        while len(reqs) < self.cfg.max_batch:
            try:
                reqs.append(self._q.get_nowait())
            except queue.Empty:
                break
        deadline = first.t_enqueue + self.cfg.max_delay_ms / 1000.0
        while len(reqs) < self.cfg.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                reqs.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return reqs

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            reqs = self._collect()
            if not reqs:
                continue
            n = len(reqs)
            b = self._bucket_for(n)
            x0 = np.zeros((b,) + self._x0_shape, np.float32)
            poke = np.zeros((b,) + self._poke_shape, np.float32)
            for i, r in enumerate(reqs):
                x0[i] = r.x0
                poke[i] = r.poke
            t0 = time.monotonic()
            try:
                # padded slots reuse request 0's seed; their outputs are
                # discarded below
                vids = self._run(x0, poke, [r.seed for r in reqs] + [reqs[0].seed] * (b - n))
                for i, r in enumerate(reqs):
                    r.result = vids[i]
            except Exception as e:  # deliver, don't kill the worker
                for r in reqs:
                    r.error = e
            t1 = time.monotonic()
            if t1 - t0 > 5.0:
                print(f"serve batcher: SLOW batch n={n} bucket={b} "
                      f"exec={t1 - t0:.1f}s", file=sys.stderr, flush=True)
            self.stats.requests += n
            self.stats.batches += 1
            self.stats.batch_hist[b] = self.stats.batch_hist.get(b, 0) + 1
            self.stats.total_exec_s += t1 - t0
            self.stats.total_wait_s += sum(t0 - r.t_enqueue for r in reqs)
            for r in reqs:
                r.event.set()

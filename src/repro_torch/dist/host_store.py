"""Host-resident feature/embedding store with staged host→device fetch —
the out-of-core tier behind the runtimes' ``features="host"`` mode and the
serve engine's host tier (the JAX package's ``dist/host_store.py``).

The paper's JACA plans a *shared CPU cache* (C_CPU) next to the per-worker
GPU caches.  The store keeps that tier on the host:

- **feature table** — the stacked halo input features stay host numpy
  (read through a CPU tensor over the same memory); each step stages
  exactly the plan's host-fetched rows (:class:`~.exchange.HostTier`) to
  the device.
- **the ring** — on the card a fetch gathers straight into one of
  ``prefetch_depth`` pinned slots of its staged dtype
  (``torch.index_select(..., out=slot)``, multi-threaded), zeroes the
  invalid (padding) rows and issues a ``non_blocking`` copy to the device
  on a side stream, recording an event.  A slot is rewritten only after
  its copy's event has completed (the backpressure of the JAX package's
  in-flight bound).  The consumer calls :meth:`HostFeatureStore.ready`:
  its stream waits for the event and the device tensor is recorded on
  that stream, so a fetch issued before a step's work rides under the
  previous step's compute.
- **global-tier buffers** — the per-exchange-layer deduplicated global
  cache ``[G, d]`` lives here between steps: refresh steps build it on
  the device and write it back (a ``non_blocking`` copy into pinned
  memory with an event, waited on only where :meth:`~HostFeatureStore.
  stage_buf` or :meth:`~HostFeatureStore.buf_table` reads it); cached
  steps stage it for the stale reads.

``halo_dtype`` mirrors the wire compression: staged payloads are cast on
the host (the link moves the narrow dtype, 2 bytes a value under bf16)
and dequantised back to the compute dtype on the device.  The global
buffers stay f32 (dequantised) on the host.

Byte accounting is exact and driven by consumption: a staged fetch is a
:class:`StagedFetch` carrying its valid-row and byte counts, recorded by
:meth:`HostFeatureStore.account_fetch` when the step that consumes it is
issued — prefetches flushed by a plan change never count.

On the CPU (``device="cpu"``) a fetch is a fresh gather: nothing is pinned
and there is no stream.

Fault injection and tracing (:meth:`~HostFeatureStore.set_faults`,
:meth:`~HostFeatureStore.set_tracer`): every stage op consults the
attached :class:`~repro_torch.faults.FaultPlan` once, after its gather
clock starts and before it takes a ring slot or gathers — an injected
drop raises :class:`~repro_torch.faults.FetchError` having taken no slot,
recorded no event and issued no copy; an injected delay stalls inside
the timed gather, so it shows in ``gather_s``.  Every copy to the device
records an ``h2d_put`` span (with its bytes) on the attached tracer.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..faults.plan import NULL_FAULTS
from ..obs.tracer import NULL_TRACER

__all__ = ["HostFeatureStore", "StagedFetch", "halo_dtype_info",
           "suggest_prefetch_depth"]


def halo_dtype_info(halo_dtype) -> tuple:
    """Normalise the halo payload dtype knob -> ``(cast dtype | None, bytes)``.

    ``None``/f32 ships halo rows at full width; ``"bf16"`` casts the
    payload before transport (wire or PCIe) to ``torch.bfloat16`` and
    dequantises back to the compute dtype on the consuming side.
    """
    if halo_dtype in (None, "f32", "fp32", "float32", torch.float32):
        return None, 4
    if halo_dtype in ("bf16", "bfloat16", torch.bfloat16):
        return torch.bfloat16, 2
    raise ValueError(f"unknown halo_dtype {halo_dtype!r}; "
                     "expected None, 'f32' or 'bf16'")


@dataclasses.dataclass(frozen=True)
class StagedFetch:
    """One host→device fetch: the device tensor (its copy possibly still
    in flight) plus the exact row/byte counts the consumer must account.
    ``event`` marks the end of the copy on the store's side stream (None
    on the CPU, and for an empty fetch); ``source`` is ``"rows"`` (a
    gather of the table) or ``"buf"`` (a global buffer)."""
    array: torch.Tensor
    rows: int          # valid rows gathered (padding rows excluded)
    nbytes: int        # rows x feat_dim x staged dtype width
    gather_s: float    # host-side gather+cast seconds (excludes transfer)
    event: object = None
    source: str = "rows"


def suggest_prefetch_depth(fetch_bytes_per_step: int, step_s: float,
                           h2d_gib_s: float, max_depth: int = 8) -> int:
    """Prefetch depth from measured H2D bandwidth: enough in-flight
    fetches to cover one step's host bytes within one step time,
    ``max(1, ceil(transfer_s / step_s))``, clamped to ``max_depth``.

    ``h2d_gib_s`` comes from a measured profile's ``h2d`` time (see
    :func:`repro_torch.core.device_profile.measure_profile`, which also
    reports ``host_mem_gib`` for capacity sizing).
    """
    if fetch_bytes_per_step <= 0 or step_s <= 0 or h2d_gib_s <= 0:
        return 2
    transfer_s = fetch_bytes_per_step / (h2d_gib_s * 1024.0 ** 3)
    return int(np.clip(np.ceil(transfer_s / step_s), 1, max_depth))


class _Slot:
    """One pinned staging buffer of the ring and the event of the last
    copy out of it."""

    def __init__(self):
        self.buf: torch.Tensor | None = None
        self.event = None

    def take(self, numel: int, dtype) -> torch.Tensor:
        """The first ``numel`` values, once the last copy out of the slot
        has completed (grown, pinned, when too small)."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        if self.buf is None or self.buf.numel() < numel:
            self.buf = torch.empty(numel, dtype=dtype, pin_memory=True)
        return self.buf[:numel]


class HostFeatureStore:
    """Host tables + staged-fetch machinery (see module docstring).

    ``feat`` is any host array whose leading index tuple selects rows:
    the training runtimes pass the stacked halo features ``[P, NH, F]``
    (one partition's ``[1, NH, F]`` on an SPMD rank) and gather by
    ``(part, halo_pos)``; the serve engine passes the precomputed logits
    table ``[N, C]`` and gathers by node id.  Fetches stage to ``device``
    (the card unless the caller asks for the CPU).

    ``timing`` (off by default) records CUDA events around every copy and
    every wait on one in ``copy_log``, read by :meth:`copy_times`.
    """

    def __init__(self, feat: np.ndarray, halo_dtype=None,
                 prefetch_depth: int = 2, device="cuda"):
        self.feat = np.ascontiguousarray(feat, dtype=np.float32)
        self.cast_dtype, self.dtype_bytes = halo_dtype_info(halo_dtype)
        self.prefetch_depth = max(1, int(prefetch_depth))
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to stage on the CPU")
        # the table as rows, and each leading index's flat row id
        width = self.feat.shape[-1]
        self._table = torch.from_numpy(self.feat).view(-1, width)
        self._ids = np.arange(self._table.shape[0]).reshape(
            self.feat.shape[:-1])
        self._slots: dict = {}      # staged dtype -> ring of _Slot
        self._next: dict = {}
        self._scratch = torch.empty(0)
        self._side = None           # the side stream of the copies
        # per-exchange-layer global-tier buffers:
        # layer -> [host f32 table, n_valid, writeback event | None]
        self._bufs: dict[int, list] = {}
        self.stats = {"fetches": 0, "fetch_rows": 0, "fetch_bytes": 0,
                      "writebacks": 0, "writeback_rows": 0,
                      "writeback_bytes": 0, "gather_s": 0.0}
        self.timing = False
        # with timing on: (kind, start event, end event) of every copy
        # ("h2d_rows" / "h2d_buf") and every wait on one ("wait_...")
        self.copy_log: list = []
        self.tracer = NULL_TRACER
        self.faults = NULL_FAULTS

    def set_tracer(self, tracer) -> None:
        """Attach a :class:`repro_torch.obs.Tracer`: every copy to the
        device records an ``h2d_put`` sub-span (nested inside whatever
        staging span the caller holds open).  Default is the shared no-op
        tracer."""
        self.tracer = tracer

    def set_faults(self, faults) -> None:
        """Attach a :class:`repro_torch.faults.FaultPlan`: every stage op
        consults it once (``on_fetch`` — injected drops raise
        :class:`repro_torch.faults.FetchError`, injected delays stall the
        host gather).  Default is the shared disabled plan, whose consult
        is a single attribute check."""
        self.faults = faults

    # -- staging -----------------------------------------------------------

    def _slot(self, dtype) -> _Slot:
        ring = self._slots.setdefault(
            dtype, [_Slot() for _ in range(self.prefetch_depth)])
        k = self._next.get(dtype, 0)
        self._next[dtype] = (k + 1) % len(ring)
        return ring[k]

    def _event(self):
        return torch.cuda.Event(enable_timing=self.timing)

    def _put(self, host: torch.Tensor, slot: _Slot | None,
             source: str) -> tuple:
        """Copy ``host`` (pinned) to the device on the side stream;
        returns the device tensor and the copy's event, which ``slot``
        (the ring slot it came from, if any) keeps."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        nbytes = host.numel() * host.element_size()
        with self.tracer.span("h2d_put", nbytes=nbytes), \
                torch.cuda.stream(self._side):
            start = self._event()
            if self.timing:
                start.record(self._side)
            out = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            out.copy_(host, non_blocking=True)
            done = self._event()
            done.record(self._side)
        if slot is not None:
            slot.event = done
        if self.timing:
            self.copy_log.append((f"h2d_{source}", start, done))
        return out, done

    def stage_rows(self, idx, valid: np.ndarray | None = None) -> StagedFetch:
        """Stage ``feat[idx]`` to the device: host gather, zero invalid
        (padding) rows, ``halo_dtype`` cast, ``non_blocking`` copy.

        ``idx`` is any numpy index into ``feat``'s leading dims (e.g.
        ``(part[:, None], halo_pos)`` for the stacked layout); ``valid``
        masks real rows.  The caller accounts the returned
        :class:`StagedFetch` via :meth:`account_fetch` when it consumes
        it, through :meth:`ready`.
        """
        t0 = time.perf_counter()
        # injected faults land inside the timed gather window, before a
        # ring slot is taken: the slow-fetch defense sees a delay through
        # ``gather_s``, and a drop leaks no slot
        if self.faults.enabled:
            self.faults.on_fetch()
        flat = self._ids[idx]
        shape = flat.shape + (self._table.shape[1],)
        ids = torch.from_numpy(np.ascontiguousarray(flat, np.int64).ravel())
        if valid is not None:
            valid = np.broadcast_to(np.asarray(valid, bool), flat.shape)
            n = int(valid.sum())
            invalid = torch.from_numpy(np.flatnonzero(~valid))
        else:
            n, invalid = int(flat.size), None
        dtype = self.cast_dtype or torch.float32
        nbytes = n * shape[-1] * self.dtype_bytes
        if self.device.type == "cpu" or not ids.numel():
            rows = torch.index_select(self._table, 0, ids)
            if invalid is not None:
                rows.index_fill_(0, invalid, 0.0)
            rows = rows.to(dtype).reshape(shape)
            if self.device.type == "cuda":
                rows = rows.to(self.device)
            return StagedFetch(array=rows, rows=n, nbytes=nbytes,
                               gather_s=time.perf_counter() - t0)
        slot = self._slot(dtype)
        t_take = time.perf_counter()
        host = slot.take(ids.numel() * shape[-1], dtype).view(-1, shape[-1])
        # the slot's wait for its last copy and its growth (pinning
        # hundreds of MB at a first large fetch, 0.1-0.2 s) are no part
        # of the gather: they would read as a slow fetch
        t0 += time.perf_counter() - t_take
        if self.cast_dtype is None:
            torch.index_select(self._table, 0, ids, out=host)
        else:
            if self._scratch.numel() < host.numel():
                self._scratch = torch.empty(host.numel())
            rows = self._scratch[:host.numel()].view(host.shape)
            torch.index_select(self._table, 0, ids, out=rows)
            host.copy_(rows)
        if invalid is not None and invalid.numel():
            host.index_fill_(0, invalid, 0.0)
        gather_s = time.perf_counter() - t0
        array, event = self._put(host.view(shape), slot, "rows")
        return StagedFetch(array=array, rows=n, nbytes=nbytes,
                           gather_s=gather_s, event=event)

    def ready(self, staged: StagedFetch) -> torch.Tensor:
        """``staged``'s device tensor, safe to read on the current stream:
        the stream waits for the copy (the compute stream's wait on the
        ring) and the tensor is recorded on it."""
        if staged.event is None:
            return staged.array
        stream = torch.cuda.current_stream(self.device)
        start = self._event()
        if self.timing:
            start.record(stream)
        stream.wait_event(staged.event)
        staged.array.record_stream(stream)
        if self.timing:
            end = self._event()
            end.record(stream)
            self.copy_log.append((f"wait_{staged.source}", start, end))
        return staged.array

    def copy_times(self, start: int = 0, stop: int | None = None) -> dict:
        """Seconds of device time in the copies to the device (``h2d_rows``
        from the ring, ``h2d_buf`` of the global buffers, on the side
        stream) and in the consumers' waits for them (``wait_rows``,
        ``wait_buf``) of ``copy_log[start:stop]``, waiting for each."""
        out = dict.fromkeys(("h2d_rows", "h2d_buf", "wait_rows",
                             "wait_buf"), 0.0)
        for kind, first, last in self.copy_log[start:stop]:
            last.synchronize()
            out[kind] += first.elapsed_time(last) / 1e3
        return out

    def fetch_rows(self, idx) -> np.ndarray:
        """Synchronous staged fetch for the serve path: stage to the
        device, account immediately, and read the rows back to numpy (the
        round trip the host tier's latency is measured over)."""
        staged = self.stage_rows(idx)
        self.account_fetch(staged)
        return self.ready(staged).float().cpu().numpy()

    def account_fetch(self, staged: StagedFetch) -> None:
        """Record one *consumed* staged fetch.  Prefetches flushed by a
        plan change are never accounted — staged == consumed stays exact."""
        self.stats["fetches"] += 1
        self.stats["fetch_rows"] += staged.rows
        self.stats["fetch_bytes"] += staged.nbytes
        self.stats["gather_s"] += staged.gather_s

    # -- global-tier buffers ----------------------------------------------

    def _host_f32(self, rows) -> torch.Tensor:
        """A host f32 copy of ``rows`` (pinned when staging to the card)."""
        rows = torch.as_tensor(rows, dtype=torch.float32)
        if self.device.type == "cpu":
            return rows.clone()
        return torch.empty(rows.shape, pin_memory=True).copy_(rows)

    def _buf(self, layer: int) -> list:
        """One layer's buffer entry, its writeback complete."""
        entry = self._bufs[layer]
        if entry[2] is not None:
            entry[2].synchronize()
            entry[2] = None
        return entry

    def write_buf(self, layer: int, device_buf: torch.Tensor, n_valid: int,
                  account: bool = True) -> None:
        """Write back one exchange layer's freshly built global buffer
        ``[G, d]`` (f32, dequantised — matching the device-mode cache
        content).  ``n_valid`` is the plan's ``glob.n_unique``.  On the
        card the copy is ``non_blocking`` into pinned memory on the
        current stream, after the step that built the buffer.  ``account``
        False writes back a replica that another store counts (the
        replicated buffer of the SPMD runtime)."""
        buf = device_buf.detach()
        if buf.is_cuda:
            host = torch.empty(buf.shape, pin_memory=True)
            host.copy_(buf, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(buf.device))
        else:
            host, event = buf.to(torch.float32, copy=True), None
        self._bufs[layer] = [host, int(n_valid), event]
        if account:
            self.stats["writebacks"] += 1
            self.stats["writeback_rows"] += int(n_valid)
            self.stats["writeback_bytes"] += int(n_valid) * host.shape[-1] * 4

    def stage_buf(self, layer: int) -> StagedFetch:
        """Stage one exchange layer's host-resident global buffer to the
        device (``halo_dtype``-cast like every staged payload)."""
        if layer not in self._bufs:
            raise KeyError(f"global buffer for exchange layer {layer} was "
                           "never written back; run a refresh step first")
        host, n_valid, _ = self._buf(layer)
        t0 = time.perf_counter()
        if self.faults.enabled:
            self.faults.on_fetch()
        payload = host
        if self.cast_dtype is not None:
            payload = torch.empty(host.shape, dtype=self.cast_dtype,
                                  pin_memory=self.device.type == "cuda")
            payload.copy_(host)
        gather_s = time.perf_counter() - t0
        nbytes = n_valid * host.shape[-1] * self.dtype_bytes
        if self.device.type == "cpu" or not host.numel():
            array = payload.clone() if payload is host else payload
            return StagedFetch(array=array.to(self.device), rows=n_valid,
                               nbytes=nbytes, gather_s=gather_s,
                               source="buf")
        array, event = self._put(payload, None, "buf")
        return StagedFetch(array=array, rows=n_valid, nbytes=nbytes,
                           gather_s=gather_s, event=event, source="buf")

    def init_buf(self, layer: int, shape: tuple, n_valid: int) -> None:
        """Zero-fill one layer's buffer (cold caches; matches the
        zero-initialised device caches of ``init_caches``)."""
        self._bufs[layer] = [self._host_f32(np.zeros(shape, np.float32)),
                             int(n_valid), None]

    def has_buf(self, layer: int) -> bool:
        return layer in self._bufs

    def buf_layers(self) -> list[int]:
        """Exchange layers with a host-resident global buffer."""
        return sorted(self._bufs)

    def buf_table(self, layer: int) -> np.ndarray:
        """Read-only view of one layer's host buffer, its writeback
        complete (do **not** mutate: a copy to the device may still be
        reading it)."""
        return self._buf(layer)[0].numpy()

    def set_buf(self, layer: int, rows: np.ndarray) -> None:
        """Replace one layer's buffer *storage* keeping its valid count
        (a copy: a staged payload may still be reading the old one)."""
        _, n_valid, _ = self._buf(layer)
        self._bufs[layer] = [self._host_f32(rows), n_valid, None]

    # -- accounting --------------------------------------------------------

    def snapshot(self) -> dict:
        return dict(self.stats)

    def delta(self, before: dict) -> dict:
        return {k: self.stats[k] - before.get(k, 0) for k in self.stats}

    def resident_bytes(self) -> int:
        """Host bytes the store holds (feature table + buffers) — what the
        out-of-core runs charge against host RAM instead of HBM."""
        return int(self.feat.nbytes + sum(
            b.numel() * b.element_size() for b, _, _ in self._bufs.values()))

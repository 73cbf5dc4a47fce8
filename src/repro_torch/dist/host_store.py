"""Host-resident feature/embedding store with staged host→device fetch —
the serve engine's host tier (and, in a later slice, the training
runtimes' out-of-core ``features="host"`` mode).

The table stays host numpy.  A fetch gathers the requested rows on the
host, casts them to the staged dtype (``halo_dtype``: PCIe moves the
narrow type), copies them into a pinned CPU tensor and issues a
``non_blocking`` copy to the device.  The byte accounting is exact and
driven by consumption: a staged fetch is a :class:`StagedFetch` carrying
its row and byte counts, recorded by :meth:`HostFeatureStore.account_fetch`
when it is consumed.

Fault injection, tracing, the global-tier buffers and the prefetch ring of
the JAX package's store come with later slices.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

__all__ = ["HostFeatureStore", "StagedFetch", "halo_dtype_info"]


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
    """One host→device fetch: the device tensor (copy possibly still in
    flight) plus the exact row/byte counts the consumer must account."""
    array: torch.Tensor
    rows: int          # valid rows gathered (padding rows excluded)
    nbytes: int        # rows x feat_dim x staged dtype width
    gather_s: float    # host-side gather+cast seconds (excludes transfer)


class HostFeatureStore:
    """Host table + staged-fetch machinery (see module docstring).

    ``feat`` is any host array whose leading index tuple selects rows: the
    serve engine passes the precomputed logits table ``[N, C]`` and gathers
    by node id.  Fetches stage to ``device``.
    """

    def __init__(self, feat: np.ndarray, halo_dtype=None, device="cuda"):
        self.feat = np.ascontiguousarray(feat, dtype=np.float32)
        self.cast_dtype, self.dtype_bytes = halo_dtype_info(halo_dtype)
        self.device = torch.device(device)
        self.stats = {"fetches": 0, "fetch_rows": 0, "fetch_bytes": 0,
                      "gather_s": 0.0}

    def _put(self, rows: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(rows)
        if self.cast_dtype is not None:
            host = host.to(self.cast_dtype)
        if self.device.type == "cpu":
            return host
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    def stage_rows(self, idx, valid: np.ndarray | None = None) -> StagedFetch:
        """Stage ``feat[idx]`` to the device: host gather, zero invalid
        (padding) rows, ``halo_dtype`` cast, ``non_blocking`` copy.

        ``idx`` is any numpy fancy index into ``feat``'s leading dims;
        ``valid`` masks real rows.  The caller accounts the returned
        :class:`StagedFetch` via :meth:`account_fetch` when it consumes it.
        """
        t0 = time.perf_counter()
        rows = self.feat[idx]
        if valid is not None:
            rows = np.where(np.asarray(valid)[..., None], rows, 0.0)
            n = int(np.asarray(valid).sum())
        else:
            n = int(np.prod(rows.shape[:-1]))
        rows = np.ascontiguousarray(rows, np.float32)
        gather_s = time.perf_counter() - t0
        return StagedFetch(array=self._put(rows), rows=n,
                           nbytes=n * rows.shape[-1] * self.dtype_bytes,
                           gather_s=gather_s)

    def fetch_rows(self, idx) -> np.ndarray:
        """Synchronous staged fetch for the serve path: stage to the
        device, account immediately, and read the rows back to numpy (the
        round trip the host tier's latency is measured over)."""
        staged = self.stage_rows(idx)
        self.account_fetch(staged)
        return staged.array.float().cpu().numpy()

    def account_fetch(self, staged: StagedFetch) -> None:
        """Record one *consumed* staged fetch."""
        self.stats["fetches"] += 1
        self.stats["fetch_rows"] += staged.rows
        self.stats["fetch_bytes"] += staged.nbytes
        self.stats["gather_s"] += staged.gather_s

    def snapshot(self) -> dict:
        return dict(self.stats)

    def delta(self, before: dict) -> dict:
        return {k: self.stats[k] - before.get(k, 0) for k in self.stats}

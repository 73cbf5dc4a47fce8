"""Device capability profiles (paper §3.4 Observation 3, Table 1/3).

The paper measures MM, SpMM, H2D, D2H and IDT per GPU and feeds the
capability ratios into RAPA (Eq. 13/14).  Two sources:

- ``measure_profile()`` — the microbenchmarks on a device (the card unless
  the caller asks for the CPU), the paper's Table 1 harness scaled down;
- ``PROFILES`` — the paper's Table 1 numbers (seconds for a 16384^2 fp32
  workload), so the cache and partition planning is reproducible without
  that exact hardware.
"""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

__all__ = ["DeviceProfile", "PROFILES", "PAPER_GROUPS", "make_group",
           "capability_weights", "detect_host_mem_gib", "measure_profile"]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Times (seconds, lower is better) for the paper's five microbenchmarks,
    plus memory capacity in GiB.  ``host_mem_gib`` sizes the shared CPU
    cache tier (JACA's C_CPU); declared Table 1 profiles keep the paper's
    16 GiB-host assumption."""
    name: str
    mm: float        # dense matmul time
    spmm: float      # sparse matmul time
    h2d: float       # host-to-device
    d2h: float       # device-to-host
    idt: float       # intra/inter-device transfer
    mem_gib: float
    host_mem_gib: float = 16.0

    def compute_caps(self) -> tuple[float, float]:
        """Capabilities = inverse time (bigger is faster)."""
        return 1.0 / self.mm, 1.0 / self.spmm

    def comm_caps(self) -> tuple[float, float, float]:
        return 1.0 / self.h2d, 1.0 / self.d2h, 1.0 / self.idt


# Paper Table 1 (means across same-model cards).
PROFILES: dict[str, DeviceProfile] = {
    "rtx3090": DeviceProfile("rtx3090", 0.1383, 0.1063, 0.1197, 0.1213, 0.0014, 24.0),
    "a40": DeviceProfile("a40", 0.1421, 0.1198, 0.1187, 0.1189, 0.0021, 48.0),
    "rtx3060": DeviceProfile("rtx3060", 0.3439, 0.1962, 0.1220, 0.1236, 0.0038, 12.0),
    "rtx2060": DeviceProfile("rtx2060", 0.4972, 0.2955, 0.1192, 0.1195, 0.0033, 6.0),
    "gtx1660ti": DeviceProfile("gtx1660ti", 0.9938, 0.3409, 0.1238, 0.1244, 0.0057, 6.0),
    "gtx1650": DeviceProfile("gtx1650", 1.2743, 0.6323, 0.1253, 0.1253, 0.0094, 4.0),
}

# Paper Table 4 groups x2..x8.
PAPER_GROUPS: dict[str, list[str]] = {
    "x2": ["rtx3090"] * 2,
    "x3": ["rtx3090"] * 2 + ["a40"],
    "x4": ["rtx3090"] * 2 + ["a40"] * 2,
    "x5": ["rtx3090"] * 2 + ["a40"] * 2 + ["rtx3060"],
    "x6": ["rtx3090"] * 2 + ["a40"] * 2 + ["rtx3060"] * 2,
    "x7": ["rtx3090"] * 2 + ["a40"] * 2 + ["rtx3060"] * 2 + ["gtx1660ti"],
    "x8": ["rtx3090"] * 2 + ["a40"] * 2 + ["rtx3060"] * 2 + ["gtx1660ti"] * 2,
}


def make_group(names: list[str]) -> list[DeviceProfile]:
    """Paper Table 4 style groups, e.g. ['rtx3090','rtx3090','a40',...]."""
    return [PROFILES[n] for n in names]


def capability_weights(profiles: list[DeviceProfile],
                       alpha: float = 0.7) -> np.ndarray:
    """Per-device partition target fractions from compute capability.

    Inverts the Eq. 14 cost mix: device i's share is proportional to
    ``1 / (alpha * spmm_i + (1 - alpha) * mm_i)`` so the weakest device
    receives the smallest inner vertex set.  ``alpha`` is the SpMM-vs-MM
    weight (same meaning as :class:`repro_torch.core.rapa.RapaConfig.alpha`).
    Returns weights normalised to sum to 1, suitable for the ``weights=``
    argument of the partitioners in :mod:`repro_torch.graph.partition`.
    """
    t = np.array([alpha * p.spmm + (1.0 - alpha) * p.mm for p in profiles],
                 dtype=np.float64)
    w = 1.0 / np.maximum(t, 1e-12)
    return w / w.sum()


def detect_host_mem_gib(default: float = 16.0) -> float:
    """Total host RAM in GiB — ``os.sysconf`` where POSIX exposes it,
    ``psutil`` as a fallback, ``default`` when neither is available.
    Feeds :func:`repro_torch.core.jaca.cal_capacity`'s CPU-tier budget."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page_size > 0:
            return pages * page_size / 1024.0 ** 3
    except (AttributeError, ValueError, OSError):
        pass
    try:
        import psutil
        return psutil.virtual_memory().total / 1024.0 ** 3
    except (ImportError, OSError):
        return default


def measure_profile(size: int = 1024, sparsity: float = 0.996,
                    repeats: int = 5, device="cuda") -> DeviceProfile:
    """Microbenchmark ``device`` (the paper's Table 1 harness, scaled):
    seconds per call of a dense ``size``^2 f32 product (``mm``), the same
    product of a matrix masked to ``1 - sparsity`` density (``spmm``: the
    JAX package times a dense product of the masked matrix too), a
    pageable host array to the device (``h2d``), a fresh device buffer to
    the host each repeat (``d2h``), and a copy on the device (``idt``).
    CUDA events time the card, ``time.perf_counter`` the CPU.  The
    device's memory comes from its properties (16 GiB on the CPU, which
    reports none), the host's from :func:`detect_host_mem_gib`."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "profile the CPU")
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((size, size), generator=gen, device=device)
    b = torch.randn((size, size), generator=gen, device=device)
    mask = torch.rand((size, size), generator=gen, device=device) > sparsity
    sp = torch.where(mask, a, torch.zeros((), device=device))

    def timed(fn, warm: bool = True) -> float:
        if warm:
            fn()
        if cuda:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(repeats):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / repeats
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        return (time.perf_counter() - t0) / repeats

    mm = timed(lambda: torch.matmul(a, b))
    spmm = timed(lambda: torch.matmul(sp, b))
    host = a.cpu().numpy()
    h2d = timed(lambda: torch.tensor(host, device=device))
    # D2H reads a fresh device buffer each repeat, as the JAX package's
    # does (JAX memoises the host copy of a committed array)
    bufs = iter([a + float(i + 1) for i in range(repeats)])
    d2h = timed(lambda: next(bufs).to("cpu", copy=True), warm=False)
    idt = timed(lambda: a + 0.0)
    mem = _backend_mem_gib(device, default=16.0)
    return DeviceProfile("measured", mm, spmm, h2d, d2h, idt, mem,
                         host_mem_gib=detect_host_mem_gib())


def _backend_mem_gib(device, default: float) -> float:
    """Device memory in GiB from the card's properties, ``default`` on the
    CPU (which reports no device memory)."""
    device = torch.device(device)
    if device.type != "cuda":
        return default
    return torch.cuda.get_device_properties(device).total_memory / 1024.0 ** 3

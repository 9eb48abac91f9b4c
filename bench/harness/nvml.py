"""The card's energy counter and power limit, read from NVML through
ctypes (``libnvidia-ml.so.1``, which the driver installs).

``nvmlDeviceGetTotalEnergyConsumption`` counts the millijoules the card
drew since the driver loaded; a window's joules are the difference of
two readings.  Everything here returns None where NVML or the counter is
missing, so the metrics that need it are left out, never made up.
"""
from __future__ import annotations

import ctypes
import threading
import time

import torch


class Nvml:
    def __init__(self, device_index: int = 0):
        self._lib = None
        self._handle = ctypes.c_void_p()
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError:
            return
        handle_p = ctypes.POINTER(ctypes.c_void_p)
        for name, args in (
                ("nvmlInit_v2", []), ("nvmlShutdown", []),
                ("nvmlDeviceGetHandleByUUID", [ctypes.c_char_p, handle_p]),
                ("nvmlDeviceGetTotalEnergyConsumption",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]),
                ("nvmlDeviceGetEnforcedPowerLimit",
                 [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        if lib.nvmlInit_v2() != 0:
            return
        uuid = str(torch.cuda.get_device_properties(device_index).uuid)
        if not uuid.startswith("GPU-"):
            uuid = "GPU-" + uuid
        if lib.nvmlDeviceGetHandleByUUID(uuid.encode(),
                                         ctypes.byref(self._handle)) != 0:
            return
        self._lib = lib

    def energy_mj(self) -> int | None:
        """The cumulative counter in millijoules, or None."""
        if self._lib is None:
            return None
        value = ctypes.c_ulonglong()
        if self._lib.nvmlDeviceGetTotalEnergyConsumption(
                self._handle, ctypes.byref(value)) != 0:
            return None
        return value.value

    def power_limit_w(self) -> float | None:
        if self._lib is None:
            return None
        value = ctypes.c_uint()
        if self._lib.nvmlDeviceGetEnforcedPowerLimit(
                self._handle, ctypes.byref(value)) != 0:
            return None
        return value.value / 1e3

    def close(self) -> None:
        if self._lib is not None:
            self._lib.nvmlShutdown()
            self._lib = None


class EnergySampler:
    """Reads the energy counter every `period_s` on a thread of its own and
    keeps (host time, millijoules) at each change of the counter, which
    NVML updates about every 100 ms.  `joules(t0, t1)` interpolates the
    counter linearly between the changes around each end, so a window's
    energy does not depend on where the counter's steps fall."""

    def __init__(self, nvml: Nvml, period_s: float = 0.005):
        self._nvml = nvml
        self._period = period_s
        self._ticks: list[tuple[float, int]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)

    def _poll(self) -> None:
        last = None
        while not self._stop.is_set():
            value = self._nvml.energy_mj()
            if value is None:
                return
            if value != last:
                self._ticks.append((time.perf_counter(), value))
                last = value
            time.sleep(self._period)

    def start(self) -> "EnergySampler":
        self._thread.start()
        return self

    def wait_ticks(self, n: int, timeout_s: float = 0.5) -> None:
        """Wait until `n` changes of the counter are kept (or
        `timeout_s`), so a window that starts now is bracketed."""
        deadline = time.perf_counter() + timeout_s
        while len(self._ticks) < n and time.perf_counter() < deadline:
            time.sleep(self._period)

    def stop_after(self, t: float, timeout_s: float = 0.5) -> None:
        """Stop once a change after host time `t` is kept (or after
        `timeout_s`), and wait for the thread."""
        deadline = time.perf_counter() + timeout_s
        while time.perf_counter() < deadline and not (
                self._ticks and self._ticks[-1][0] > t):
            time.sleep(self._period)
        self._stop.set()
        self._thread.join()

    def _at(self, t: float) -> float | None:
        ticks = self._ticks
        for (ta, ea), (tb, eb) in zip(ticks, ticks[1:]):
            if ta <= t <= tb:
                return ea + (eb - ea) * (t - ta) / (tb - ta)
        return None

    def joules(self, t0: float, t1: float) -> float | None:
        """Energy the card drew in [t0, t1], or None when the counter's
        changes do not bracket both ends."""
        e0, e1 = self._at(t0), self._at(t1)
        if e0 is None or e1 is None:
            return None
        return (e1 - e0) / 1e3

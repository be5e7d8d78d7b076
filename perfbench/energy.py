"""The card's own energy counter, read through NVML with ``ctypes``.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the card has
used since its driver loaded; a reading is its difference over the
window.  A card without the counter raises (the H100 has it).  The card's
enforced power limit is read beside it, since a card set below its limit
runs slower.
"""

from __future__ import annotations

import ctypes


class Nvml:
    """One card's energy meter (the card of CUDA device 0 of this
    process, found by UUID)."""

    source = "nvml_total_energy"

    def __init__(self, uuid: str | None):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._check(self.lib.nvmlInit_v2(), "nvmlInit_v2")
        self.handle = ctypes.c_void_p()
        rc = 1
        if uuid:
            rc = self.lib.nvmlDeviceGetHandleByUUID(
                ctypes.c_char_p(uuid.encode()), ctypes.byref(self.handle))
        if rc != 0:
            self._check(self.lib.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(0), ctypes.byref(self.handle)),
                "nvmlDeviceGetHandleByIndex_v2")

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} returned NVML error {rc}")

    def _total(self) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(mj)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3

    def power_limit_w(self) -> float:
        """The enforced power limit, watts."""
        mw = ctypes.c_uint()
        self._check(self.lib.nvmlDeviceGetEnforcedPowerLimit(
            self.handle, ctypes.byref(mw)), "nvmlDeviceGetEnforcedPowerLimit")
        return mw.value / 1e3

    def start(self) -> None:
        """Begin a reading."""
        self._e0 = self._total()

    def stop(self) -> float:
        """End the reading: joules since :meth:`start`."""
        return self._total() - self._e0

    def close(self) -> None:
        """Release NVML."""
        self.lib.nvmlShutdown()

"""The card's own record through NVML, by ctypes on ``libnvidia-ml.so.1``.

``Card`` opens the card that CUDA device 0 is (matched by UUID), reads
its name, power limit and clocks, and its total-energy counter
(``nvmlDeviceGetTotalEnergyConsumption``, millijoules since the driver
loaded). Anything missing raises: there is no fallback to a model of
power or to another card.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

NVML_CLOCK_SM, NVML_CLOCK_MEM = 1, 2
NVML_TEMPERATURE_GPU = 0


class NVMLError(RuntimeError):
    pass


class Card:
    def __init__(self, uuid: str):
        try:
            self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        except OSError as e:
            raise NVMLError(f"libnvidia-ml.so.1 not loadable: {e}") from e
        lib = self.lib
        self.handle = ctypes.c_void_p()
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetHandleByUUID.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetHandleByUUID.restype = ctypes.c_int
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.nvmlDeviceGetTotalEnergyConsumption.restype = ctypes.c_int
        lib.nvmlDeviceGetPowerManagementLimit.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetPowerManagementLimit.restype = ctypes.c_int
        lib.nvmlDeviceGetClockInfo.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetClockInfo.restype = ctypes.c_int
        lib.nvmlDeviceGetName.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint]
        lib.nvmlDeviceGetName.restype = ctypes.c_int
        lib.nvmlDeviceGetPowerUsage.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetPowerUsage.restype = ctypes.c_int
        lib.nvmlDeviceGetTemperature.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetTemperature.restype = ctypes.c_int
        lib.nvmlDeviceGetCurrentClocksThrottleReasons.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.nvmlDeviceGetCurrentClocksThrottleReasons.restype = ctypes.c_int
        lib.nvmlShutdown.restype = ctypes.c_int
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._check(lib.nvmlDeviceGetHandleByUUID(
            uuid.encode(), ctypes.byref(self.handle)),
            f"nvmlDeviceGetHandleByUUID({uuid})")
        self.energy_mj()          # the counter must be readable now

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise NVMLError(f"{what} returned NVML error {rc}")

    def energy_mj(self) -> int:
        v = ctypes.c_ulonglong()
        self._check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            self.handle, ctypes.byref(v)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return int(v.value)

    def record(self) -> Dict[str, object]:
        name = ctypes.create_string_buffer(96)
        self._check(self.lib.nvmlDeviceGetName(self.handle, name, 96),
                    "nvmlDeviceGetName")
        limit, sm, mem = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
        self._check(self.lib.nvmlDeviceGetPowerManagementLimit(
            self.handle, ctypes.byref(limit)),
            "nvmlDeviceGetPowerManagementLimit")
        self._check(self.lib.nvmlDeviceGetClockInfo(
            self.handle, NVML_CLOCK_SM, ctypes.byref(sm)),
            "nvmlDeviceGetClockInfo(SM)")
        self._check(self.lib.nvmlDeviceGetClockInfo(
            self.handle, NVML_CLOCK_MEM, ctypes.byref(mem)),
            "nvmlDeviceGetClockInfo(MEM)")
        return {"name": name.value.decode(), "power_limit_w":
                limit.value / 1e3, "sm_clock_mhz": sm.value,
                "mem_clock_mhz": mem.value}

    def state(self) -> Tuple[int, float, int, int]:
        """SM clock (MHz), power draw (W), temperature (C) and the
        clock-limiting reasons' bit mask, as of now."""
        sm, mw, temp = ctypes.c_uint(), ctypes.c_uint(), ctypes.c_uint()
        why = ctypes.c_ulonglong()
        lib = self.lib
        self._check(lib.nvmlDeviceGetClockInfo(
            self.handle, NVML_CLOCK_SM, ctypes.byref(sm)),
            "nvmlDeviceGetClockInfo(SM)")
        self._check(lib.nvmlDeviceGetPowerUsage(self.handle, ctypes.byref(mw)),
                    "nvmlDeviceGetPowerUsage")
        self._check(lib.nvmlDeviceGetTemperature(
            self.handle, NVML_TEMPERATURE_GPU, ctypes.byref(temp)),
            "nvmlDeviceGetTemperature")
        self._check(lib.nvmlDeviceGetCurrentClocksThrottleReasons(
            self.handle, ctypes.byref(why)),
            "nvmlDeviceGetCurrentClocksThrottleReasons")
        return sm.value, mw.value / 1e3, temp.value, why.value

    def close(self) -> None:
        self.lib.nvmlShutdown()


class Sampler:
    """The card's clock, power, temperature and clock-limiting reasons,
    sampled every ``period_s`` by a thread for ``seconds``: a record of
    the window beside its numbers (only logged, never a metric)."""

    def __init__(self, card: Card, seconds: float, period_s: float = 0.5):
        self._n = max(int(seconds / period_s), 1)
        self.rows: List[Tuple[int, float, int, int]] = []
        self._card = card
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(period_s,),
                                        daemon=True)
        self._thread.start()

    def _run(self, period_s: float) -> None:
        while len(self.rows) < self._n and not self._stop.wait(period_s):
            self.rows.append(self._card.state())

    def stop(self) -> Dict[str, object]:
        self._stop.set()
        self._thread.join()
        if not self.rows:
            return {}
        sm, w, temp, why = zip(*self.rows)
        reasons = 0
        for r in why:
            reasons |= r
        return {"samples": len(sm), "sm_mhz_mean": sum(sm) / len(sm),
                "sm_mhz_min": min(sm), "power_w_mean": sum(w) / len(w),
                "temp_c_max": max(temp), "limit_reasons": hex(reasons)}

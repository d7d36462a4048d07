"""What a kind of traffic gets from the run and hands back to it."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch


def since_process_start() -> float:
    """Seconds since this process started, on the kernel's clock (10 ms
    resolution); the interpreter's own start-up included."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22 of stat, counted after the command name
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclass
class Ctx:
    device: torch.device
    seed: int
    seconds: float
    trace: bool
    control: str | None = None  # a lower-precision control in the program's place
    fault: str | None = None  # a planted fault (the fault tests and readings)
    setup_s: float | None = None
    memory_peak_bytes: int = 0

    def window_opens(self):
        """Record the set-up time: everything before the measured window."""
        self.synchronize()
        self.setup_s = since_process_start()

    def synchronize(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_closed(self):
        """Read the memory peak before the program's state is freed and the
        reference runs."""
        self.synchronize()
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        """Return the program's freed memory to the card before the reference."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


@dataclass
class Result:
    units: int = 0  # whole batches or steps completed in the window
    unit_size: int = 0  # waveforms a batch, samples a step
    window_s: float = 0.0
    failed: int = 0  # waveforms or samples that came out non-finite
    readings: dict = field(default_factory=dict)  # compared numbers, by name
    layer: dict = field(default_factory=dict)  # what the per-layer readers read

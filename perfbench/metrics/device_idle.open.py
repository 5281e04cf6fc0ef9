"""device_idle.open: 1 - (union of device operations' intervals) / the
traced sub-window, in %, from the profiler's trace."""

from perfbench.harness import readers

read = readers.device_idle

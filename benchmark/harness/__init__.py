"""The general parts of the benchmark: the cell's files by name, the inputs
from the seed, the loop, the profiler window, the roofline arithmetic and
the comparison that decides ``correct``."""

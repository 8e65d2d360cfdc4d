"""The benchmark of ``metrics_tpu_torch``, the PyTorch and CUDA port.

Run one cell from the root of a checkout::

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root
lists the cells, ``benchmark/configs/<config>.json`` holds a configuration's
sizes and members, ``benchmark/traffic/<traffic>.json`` a traffic mix,
``benchmark/limits/<workload>.json`` the limits of a cell's comparison,
``benchmark/reference/<workload>.py`` or ``<config>.py`` the plain
reference of a cell or of a configuration, ``benchmark/data/<kind>.py`` the
generator of a kind of input that a configuration or a traffic names,
``benchmark/kernels/<kernel>.py`` the names and the work of one of the
port's kernels that a member names, and ``benchmark/metrics/<metric>.py``
the reader of a metric.
"""

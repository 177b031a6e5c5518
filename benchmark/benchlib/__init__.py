"""The benchmark's yardstick: seeded inputs, published peaks, operation and
byte counts, the profiler reading and the comparisons that decide
``correct``. Nothing here imports the program (``laplace_gnn_torch``)."""

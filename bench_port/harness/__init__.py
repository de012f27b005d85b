"""The benchmark's general code: the registry of cells, configurations,
traffic mixes, loops and per-layer metrics (each found by its name), the
timed window, the trace reader, the frozen roofline arithmetic and the
correctness check."""

"""The measurement discipline the port's trade-off layer shares (the port
of ``repro.bench.timing``): warmup, repeat, reduce, a device that has
finished its work inside every sample, and the link calibration that
turns exchanged bytes into seconds."""

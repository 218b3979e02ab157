"""Plain fp32 references of the port's blocks, for its tests and the benchmark's check."""

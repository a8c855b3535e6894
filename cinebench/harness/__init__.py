"""The benchmark's general code: manifest, inputs, weights, the driving of the
program, traces, metric readers and the comparison that decides ``correct``."""

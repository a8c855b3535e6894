"""Device ms of convolution kernels (cuDNN, cuBLAS) per traced item (serve)."""

from cinebench.harness.readers import kind_ms


def read(run):
    return kind_ms(run, "serve", "conv")

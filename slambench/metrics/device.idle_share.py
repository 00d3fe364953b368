"""The share of the traced window in which nothing ran on the device:
1 - (union of its kernels, copies and memsets) / (the window)."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)

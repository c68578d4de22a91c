"""Device transform: device ms a step of the kernels launched inside the
benchmark's range around ``device_transform`` (augment and imputation)."""


def read(rec):
    return rec.trace.device_us(
        under=lambda n: n == "h100bench.device_transform") / (
        1e3 * rec.slice_steps)

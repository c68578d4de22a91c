"""Trunk BatchNorm: device ms a step of the kernels whose names hold
``batch_norm`` or that a BatchNorm operator launched, forward and
backward."""


def read(rec):
    def bn(name):
        return "batch_norm" in name.lower() or "batchnorm" in name.lower()

    return rec.trace.device_us(kernels=bn, under=bn) / (
        1e3 * rec.slice_steps)

"""Host pipeline: mean ms a step that the benchmark waited in ``next()``
of the port's batch iterator (``PackedDataSource``: the producer
thread's memmap gather and pinning), in the traced slice."""


def read(rec):
    return rec.trace.host_us(lambda n: n == "h100bench.next_batch") / (
        1e3 * rec.slice_steps)

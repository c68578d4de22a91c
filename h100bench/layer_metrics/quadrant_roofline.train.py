"""Quadrant block, training form: the least time of its calls' work
(``counts.quadrant_count``) over the device time attributed to the
forward operator (the autograd function ``QuadrantProcess``, or the
operator ``surya_tpu_torch::quadrant_process``), in %."""


def read(rec):
    import counts

    return rec.roofline(("surya_tpu_torch::quadrant_process", "QuadrantProcess"),
                        counts.quadrant_count)

"""Fusion head, training form: the least time of its calls' work
(``counts.fusion_head_count``) over the device time attributed to the
forward operator (``FusionHead`` or ``surya_tpu_torch::fusion_head``),
in %."""


def read(rec):
    import counts

    return rec.roofline(("surya_tpu_torch::fusion_head", "FusionHead"),
                        counts.fusion_head_count)

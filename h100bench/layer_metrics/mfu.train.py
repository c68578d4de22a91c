"""Whole step: the analytic FLOPs of the images trained in the window
(``counts.train_flops``) over the window's seconds and the peak, in %."""


def read(rec):
    return rec.mfu()

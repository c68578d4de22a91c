"""Device: the share of the traced slice in which no kernel or copy ran,
in %."""


def read(rec):
    return rec.idle()

"""Dataset preparation: host file tools (frame renaming, flat and
sequence layouts), still-image and sequence feature extraction, and the
reference-artifact ingestion; ported from ``surya_tpu/data/prep``."""

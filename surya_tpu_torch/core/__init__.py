"""Config tree and presets (a copy of ``surya_tpu.core.config``)."""

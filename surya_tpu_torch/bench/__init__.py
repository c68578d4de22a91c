"""Host-side measurements of the port (``input_pipeline``: JPEG decode
and the packed cache). The port's device benchmark is still to come
(ROADMAP A5)."""

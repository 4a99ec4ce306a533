"""Demo scenes of the port (a copy of part of `forma_tpu/demos`)."""

"""Profiling and debug tools of the port (port of orthosfm_tpu/utils)."""

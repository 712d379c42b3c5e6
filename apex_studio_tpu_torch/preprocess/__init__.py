"""Preprocessor framework of the port (port of ``apex_studio_tpu/preprocess``:
the registry, ``run_preprocessor`` and ``load_frames``; no preprocessor is
ported yet, so the registry is empty)."""

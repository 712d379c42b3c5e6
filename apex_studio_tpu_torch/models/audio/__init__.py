"""Audio encoders (port of ``apex_studio_tpu/models/audio``): wav2vec2."""

from apex_studio_tpu_torch.manifest.loader import load_manifest, validate_and_normalize  # noqa: F401

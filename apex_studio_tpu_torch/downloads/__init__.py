"""Weight downloads (port of ``apex_studio_tpu/downloads``)."""

from apex_studio_tpu_torch.downloads.api import download_file, download_lora, is_downloaded  # noqa: F401

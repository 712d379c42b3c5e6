from apex_studio_tpu_torch.utils.defaults import (  # noqa: F401
    get_cache_path,
    get_components_path,
)
from apex_studio_tpu_torch.utils.progress import (  # noqa: F401
    ProgressReporter,
    make_mapped_progress,
    safe_emit_progress,
)

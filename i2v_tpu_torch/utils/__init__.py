"""Paths, the artifact protocol, the throughput meter."""

from .artifacts import (  # noqa: F401
    adv_filename,
    list_adv_files,
    load_adv_batch,
    run_dir_name,
    save_adv_clip,
    save_loss_info,
)
from .paths import VIDEO_MODEL_NAMES, get_paths  # noqa: F401

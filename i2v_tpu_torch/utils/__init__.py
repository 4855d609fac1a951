"""Paths, the artifact protocol, meters."""

from .artifacts import (  # noqa: F401
    adv_filename,
    list_adv_files,
    load_adv_batch,
    run_dir_name,
    save_adv_clip,
    save_loss_info,
)
from .meters import AverageMeter  # noqa: F401
from .paths import VIDEO_MODEL_NAMES, get_paths  # noqa: F401

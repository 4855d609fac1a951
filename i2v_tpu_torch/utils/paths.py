"""Path configuration through the same ``I2V_TPU_*`` environment variables as
``i2v_tpu.utils.paths`` (reference C1: utils.py:7-24)."""

from __future__ import annotations

import dataclasses
import os

# The curated attack-set manifests ship as data files inside the package (a
# byte-for-byte copy of the JAX package's).
MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "manifests")

# the six reference video models (reference: utils.py:8-15)
VIDEO_MODEL_NAMES = (
    "i3d_resnet50",
    "i3d_resnet101",
    "slowfast_resnet50",
    "slowfast_resnet101",
    "tpn_resnet50",
    "tpn_resnet101",
)


@dataclasses.dataclass(frozen=True)
class Paths:
    opt_path: str          # attack artifact root (reference OPT_PATH)
    kinetics_data: str     # directory containing Kinetics mp4s
    kinetics_anno: str     # kinetics400_attack_samples.csv
    ucf_image_root: str    # UCF-101 frame-JPEG root
    ucf_setting: str       # test01_setting.txt
    ucf_used_idxs: str     # used_idxs.pkl
    ucf_ckpt_path: str     # fine-tuned UCF checkpoints
    ckpt_path: str         # model checkpoints


def _manifest_default(env_val: str | None, cwd_name: str, packaged: str) -> str:
    """Explicit env var > a copy in the CWD > the packaged copy."""
    if env_val:
        return env_val
    if os.path.exists(cwd_name):
        return cwd_name
    return os.path.join(MANIFEST_DIR, packaged)


def get_paths() -> Paths:
    env = os.environ.get
    return Paths(
        opt_path=env("I2V_TPU_OPT_PATH", "./outputs"),
        kinetics_data=env("I2V_TPU_KINETICS_DATA", ""),
        kinetics_anno=_manifest_default(env("I2V_TPU_KINETICS_ANNO"),
                                        "./kinetics400_attack_samples.csv",
                                        "kinetics400_attack_samples.csv"),
        ucf_image_root=env("I2V_TPU_UCF_IMAGE_ROOT", ""),
        ucf_setting=_manifest_default(env("I2V_TPU_UCF_SETTING"), "./test01_setting.txt",
                                      "test01_setting.txt"),
        ucf_used_idxs=_manifest_default(env("I2V_TPU_UCF_USED_IDXS"), "./used_idxs.pkl",
                                        "used_idxs.pkl"),
        ucf_ckpt_path=env("I2V_TPU_UCF_CKPT_PATH", ""),
        ckpt_path=env("I2V_TPU_CKPTS", "./checkpoints"),
    )

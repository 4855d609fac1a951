"""Image-guided attack CLI, UCF-101 (reference C25: image_main_ucf101.py).

    python -m i2v_tpu_torch.cli.image_main_ucf101 --attack_method AENS_I2V_MF

Same flow as :mod:`.image_main`, with the ``UCF101_Image-…`` run-directory
prefix, 10 steps by default, and, under ``--fused_eval``, the video models'
101-class heads and 101 report rows (reference: image_main_ucf101.py:53-91).
``--data kinetics`` reads the UCF-101 frame JPEGs, as ``--data ucf101``.
"""

from __future__ import annotations

from . import image_main


def main(argv=None) -> str:
    args = image_main.arg_parse(argv, kind="UCF101_Image", default_step=10)
    if args.data == "kinetics":
        args.data = "ucf101"
    return image_main.run(args)


if __name__ == "__main__":
    main()

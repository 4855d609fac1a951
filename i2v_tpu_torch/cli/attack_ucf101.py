"""White-box attack CLI, UCF-101 (reference C23: attack_ucf101.py).

    python -m i2v_tpu_torch.cli.attack_ucf101 --model i3d_resnet50 --attack_method BIM

Same flow and flags as :mod:`.attack`, with the fine-tuned models'
101-class heads at full width and the ``UCF101_Video_{model}-…`` run
directory (reference: attack_ucf101.py:56-59,74-79), the JAX CLI's.
``--data kinetics`` reads the UCF-101 frame JPEGs, as ``--data ucf101``.
"""

from __future__ import annotations

from . import attack


def main(argv=None) -> str:
    return attack.run(attack.arg_parse(argv, ucf101=True))


if __name__ == "__main__":
    main()

"""Transfer-evaluation CLI, UCF-101 (reference C28: reference_ucf101.py):
the six video models with their 101-class heads, 101 report rows.

    python -m i2v_tpu_torch.cli.evaluate_ucf101 --adv_path <run-dir-or-name>
"""

from __future__ import annotations

from . import evaluate


def main(argv=None) -> dict:
    args = evaluate.arg_parse(argv, n_classes=101)
    args.ucf101 = True
    return evaluate.run(args)


if __name__ == "__main__":
    main()

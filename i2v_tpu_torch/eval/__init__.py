"""Transfer evaluation with the reference's reports."""

from .transfer import evaluate_run, reference_eval, single_pass_eval  # noqa: F401

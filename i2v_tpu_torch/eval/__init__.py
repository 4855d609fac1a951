"""Transfer evaluation with the reference's reports, fused generate→evaluate
(:mod:`.fused`) and Grad-CAM saliency (:mod:`.gradcam`)."""

from .transfer import evaluate_run, reference_eval, single_pass_eval  # noqa: F401

"""Hand-derived batched programs for hot compute paths."""

from klara_tpu.ops.logreg import make_logreg_target

__all__ = ["make_logreg_target"]

"""Device milliseconds a step inside the program's ``tq::backward`` span:
``loss.backward()``, the GroupNorm backward's recompute
(``tq::group_norm_silu_backward``) included."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    return None if spans is None else spans.per_unit("tq::backward")

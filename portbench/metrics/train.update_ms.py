"""Device milliseconds a step inside the program's ``tq::update`` span:
``apply_updates``, the optimizer (fused Adam), ``zero_grad`` and the EMA."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    return None if spans is None else spans.per_unit("tq::update")

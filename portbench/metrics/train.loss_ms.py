"""Device milliseconds a step inside the program's ``tq::loss`` span: the
forward with its draws (sigma, noise, dropout) and the loss."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    return None if spans is None else spans.per_unit("tq::loss")

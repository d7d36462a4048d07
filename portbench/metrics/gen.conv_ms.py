"""Device milliseconds a batch inside the program's ``tq::conv`` spans: every
convolution with its casts and bias add, the UNet's and the decoder's."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    return None if spans is None else spans.per_unit("tq::conv")

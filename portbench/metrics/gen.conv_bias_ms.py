"""Device milliseconds a batch inside the program's ``tq::conv_bias`` spans: the
convolutions' bias, and a ResBlock's embedding shift, added in place after cuDNN
(``ops/conv_bias.py``), inside ``tq::conv``.  None for a program without that span."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    return None if spans is None else spans.per_unit("tq::conv_bias")

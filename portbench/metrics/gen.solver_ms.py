"""Device milliseconds a batch of the sampler's own arithmetic: the kernels
launched inside the program's ``tq::sample`` and inside neither a
``tq::denoise`` (a network evaluation) nor the ``tq::decode``."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    return None if spans is None else spans.per_unit("tq::sample",
                                                     ("tq::denoise", "tq::decode"))

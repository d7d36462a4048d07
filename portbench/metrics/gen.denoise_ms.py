"""Device milliseconds a network evaluation: the kernels launched inside the
program's ``tq::denoise`` spans (the preconditioning and the UNet forward)
over the number of those spans."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    ms = None if spans is None else spans.ms("tq::denoise")
    return None if ms is None else ms / spans.count["tq::denoise"]

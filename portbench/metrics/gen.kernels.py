"""Device operations a batch (kernels, copies and memsets) launched inside the
program's ``tq::generate``."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    if spans is None or "tq::generate" not in spans.count:
        return None
    return spans.generate_ops / spans.units

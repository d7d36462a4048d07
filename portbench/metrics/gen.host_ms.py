"""Host milliseconds a batch inside the program's ``tq::generate``, on the
calling thread, less the time in CUDA runtime and driver calls nested in it
(the waits on a full launch queue among them): the host's own cost of
issuing a batch, with the profiler on."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    if spans is None or "tq::generate" not in spans.count:
        return None
    return spans.generate_host_us / 1e3 / spans.units

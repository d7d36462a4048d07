"""Device milliseconds a batch inside the program's ``tq::norm`` spans and
outside their ``tq::group_norm_silu``: ``Norm32``'s layout copies and casts
around the GroupNorm."""

from portbench.harness import program_spans


def read(run):
    spans = program_spans.reading(run)
    return None if spans is None else spans.per_unit("tq::norm", ("tq::group_norm_silu",))

"""One module a kind of traffic (``generate``, ``train``): ``run(cell, ctx)``
builds the system of the cell's configuration, drives it with the mix and
hands back what the metric readers and the comparisons read."""

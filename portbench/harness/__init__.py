"""What every cell shares: the registry of configurations, traffic mixes and
metric readers, the seeded inputs, the spans and the trace's reduction, the
operation counts and the comparisons."""

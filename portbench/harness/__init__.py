"""The parts of the benchmark that every cell shares: reading
`BENCHMARK.json` and the files it names, seeded inputs and weights, the
device checks, the trace reduction and the comparison that decides
`correct`."""

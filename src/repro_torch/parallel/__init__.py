"""The parallel layer (the port of ``repro.parallel``): sharding rules
and placements, abstract inputs, collectives over the logical devices of
a mesh, the quantized all-reduce and the GPipe pipeline."""

"""Graph substrate: host-side CSR (numpy) and its tooling (generators, the
disjoint union ``batch.batch_graphs``, the fan-out ``sampler``, the PyG / DGL
layout converters ``convert``), and the device-side ELL layout."""

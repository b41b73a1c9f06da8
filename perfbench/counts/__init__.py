"""Operations and bytes of the work the benchmark measures, as functions of
shape: one file per kernel or model family, read by the per-layer metrics."""

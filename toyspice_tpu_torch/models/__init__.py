"""Device and source models of the port as batched f64 torch functions."""

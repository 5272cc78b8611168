"""Device models as batched f64 torch functions over parameter tables.

Each module evaluates one device family's currents/conductances/charges for
*all* instances of that kind at once (tensors over the instance axis, the
batch axis first), from (params, linearization voltages, committed state,
time/step inputs).  The index bookkeeping (which matrix entries the values
land in) lives in ops/assemble.py; the math here mirrors the reference's
pkg/device/*.go with deviations documented inline, as the JAX package's
models do.
"""

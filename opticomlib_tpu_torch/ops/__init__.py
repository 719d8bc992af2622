"""Device operators of the port: split-step solver, eye metrology, pulses,
filters, noise, and the hand-written kernels (:mod:`.kernels`)."""

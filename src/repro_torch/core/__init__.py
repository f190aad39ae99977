"""Core numerics of the port: bit-packed residual masks, fixed point and
the attribution rules."""

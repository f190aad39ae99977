"""Core numerics of the port (bit-packed residual masks)."""

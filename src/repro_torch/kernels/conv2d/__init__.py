"""Convolution: kernel wrappers (``conv2d``, int16 ``fxp``) and plain
versions (``ref``)."""

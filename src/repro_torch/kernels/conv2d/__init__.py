"""Convolution: kernel wrappers (``conv2d``) and plain versions (``ref``)."""

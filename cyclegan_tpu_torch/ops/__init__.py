"""Tensor ops of the port: padding, instance norm, upsampling."""

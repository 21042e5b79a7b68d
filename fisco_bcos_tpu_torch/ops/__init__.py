"""Tensor operations of the port: limb field, keccak, EC ladder, kernels."""

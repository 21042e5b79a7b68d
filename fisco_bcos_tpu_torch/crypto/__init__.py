"""Crypto layer of the port: the fused admission program and host oracles."""

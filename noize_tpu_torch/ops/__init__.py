"""Tensor ops of the port (noise, blur, flow, thermal, mesh)."""

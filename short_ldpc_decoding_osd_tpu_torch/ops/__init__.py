"""Decoder operations: dense NMS, edge-layout kernels, GF(2), OSD terms."""

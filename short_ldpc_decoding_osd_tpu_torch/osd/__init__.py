"""OSD: TEP segmentation and the batched engine."""

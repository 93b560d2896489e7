"""Roofline accounting of a step on an NVIDIA card (`roofline.analysis`)."""

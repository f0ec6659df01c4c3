"""Roofline terms against the H100 profile, model FLOPs, and the FLOP
count of an eager step (port of ``repro/roofline/``)."""

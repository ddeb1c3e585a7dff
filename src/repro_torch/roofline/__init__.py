"""Roofline of the port: the card's peaks (``hw``) and the work a step
does, counted over one step on ``meta`` tensors (``analysis``)."""

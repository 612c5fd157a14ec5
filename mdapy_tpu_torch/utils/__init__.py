"""Host utilities of the port: ``Spline`` and the thread knob."""

"""Per-layer metric readers: ``<family>.py`` defines ``read(reading,
suffix)`` (``trace.Reading``; ``suffix`` the part of the metric's name
after the first dot, or None) and returns the number, or None where the
stretch holds nothing for it to read."""
